"""Architecture zoo (``repro.models.zoo``): ``ArchConfig`` whole, and every
family of the JAX package (dense, VLM, audio, MoE with or without MLA,
hybrid, and ``ssm``: xLSTM) for prefill (``forward``), DeepSeek's MTP head
(``mtp_logits``) and serving (``init_cache``, ``serve_step``).

Params are nested dicts with the JAX package's keys, stacked leaves for the
layer stack and ``(in, out)`` weights, so a JAX ``zoo.init_params`` tree
carries across with ``repro_torch.convert.params_from_numpy``. The layer
stack is a Python loop (the JAX ``lax.scan``); Zamba2's shared block's
``lax.cond`` on ``(i + 1) % period == 0`` is a Python ``if``. xLSTM's
blocks are a list (``params["blocks_list"]``, its cache ``{"xlstm":
[...]}``) of sLSTM and mLSTM dicts. Every MHA/GQA/MQA layer's prefill core
is the ``swa_attention`` kernel (the MTP head's dense block too); MLA and
xLSTM are plain PyTorch, as the JAX package computes them outside any
kernel.

Training (``loss_fn``, ``init_train_state``, ``train_step``) is the JAX
package's: cross-entropy with masked labels plus the MoE aux losses and
the MTP head's, and AdamW with bias correction and fp32 moments. The
backward runs through autograd, and through the kernels' own backward
kernels (``SwaAttentionFn``, ``SsdIntraChunkFn``) on the card. With
``cfg.remat`` each layer body (xLSTM: each block, and each unit of
``xlstm_scan_units``) is ``torch.utils.checkpoint``ed, as the reference
wraps it in ``jax.checkpoint``. ``train_step`` updates the state in place,
leaf by leaf, so a step never holds two copies of params and moments.

Tensor parallelism (``mesh=``, a ``launch.mesh.FedMesh``): a rank holds
its blocks of the parameters (``shard_params``, by
``sharding.specs.param_specs``), of the decode cache (``init_cache(...,
mesh=)``, by ``cache_specs``) or of a train state (``init_train_state(...,
mesh=)``, ``shard_state``, by ``state_specs``) and its data slice's rows
of the batch (``data_specs``); ``forward``, ``mtp_logits`` and
``serve_step`` run the rank's blocks, each layer summing or gathering
over the model group where its specs split it (``modules.ModelAxis``),
and return the whole logits of the rank's rows. ``serve_step``'s
``kv_spec`` (one layer's cache spec) with a slot dim over the model axis
selects the slot-split decode. ``loss_fn`` and ``train_step`` run the
backward through those collectives (their autograd Functions), with the
vocab-parallel cross-entropy (``modules.vocab_ce_sum``: the logits are
never gathered); ``train_step`` then sums each gradient over the data
slices and updates the rank's blocks in place. The layouts of
``state_specs``: ``zero`` (ZeRO-1: the moments' blocks over "data"; a
rank updates its block of each parameter, which the data axis gathers
back), ``fsdp`` (ZeRO-3, training and serving: the parameters over
"data", gathered where a layer uses them, inside its remat, the
gradient summed and cut in the gather's backward), ``moe_2d`` (training:
the expert stacks over ("data", "model"), every slice's tokens exchanged
with the experts' ranks, ``moe``) and ``batch_over_model`` (the batch
over the model axis too: gathered over the model group at entry where a
leaf is split over it, else a batch over every rank of the world). A
mesh of one rank is the path of one device, bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.modules import (ModelAxis, data_dim, dense_init,
                                        embed_init, embed_lookup, init_mlp,
                                        init_rmsnorm, mlp_apply, rmsnorm,
                                        tree_index, tree_leaves, tree_map,
                                        tree_stack, vocab_ce_sum,
                                        vocab_logits)
from repro_torch.optim.solvers import adamw_update
from repro_torch.sharding import specs as sh


# ===========================================================================
# Config
# ===========================================================================

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp_act: str = "silu"
    mlp_gated: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    causal: bool = True
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"        # scatter (baseline) | grouped (§Perf)
    # --- MLA (DeepSeek)
    mla: bool = False
    mtp: bool = False                # DeepSeek multi-token-prediction head
    mtp_weight: float = 0.3
    q_rank: int = 1536
    kv_rank: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # --- SSM (Mamba2)
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 128
    # --- hybrid (Zamba2)
    shared_attn_period: int = 0      # >0: shared attn block every N layers
    # --- xLSTM
    xlstm_pattern: Tuple[str, ...] = ()   # 'm' / 's' per layer
    mlstm_proj_factor: int = 2
    xlstm_chunk: int = 32
    mlstm_impl: str = "recurrent"    # recurrent (baseline) | chunkwise (§Perf)
    xlstm_scan_units: bool = False   # scan over periodic layer units (§Perf):
                                     # bounds live buffers to ONE unit instead
                                     # of the whole python-loop stack
    # --- modality frontend (stub per the carve-out)
    frontend: str = "none"           # none | audio | vision
    frontend_dim: int = 0
    n_patches: int = 256
    # --- attention variant
    window: Optional[int] = None     # sliding-window size (None = full)
    attn_q_chunk: Optional[int] = None  # query-chunked attention (§Perf)
    # --- numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    norm_eps: float = 1e-5
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    lr: float = 3e-4
    weight_decay: float = 0.1
    source: str = ""                 # citation for the config

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return (self.vocab_size + 255) // 256 * 256

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def decode_supported(self) -> bool:
        return self.family != "audio"

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is supported (O(1)/O(window) state)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def with_window(self, window: int) -> "ArchConfig":
        return dataclasses.replace(self, window=window)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid", "ssm")


def _check_family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


# ===========================================================================
# Parameter init
# ===========================================================================

def _init_dense_block(gen, cfg: ArchConfig, device):
    return {
        "ln1": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, cfg.p_dtype,
                                    cfg.qkv_bias, device),
        "ln2": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                        cfg.p_dtype, device),
    }


def _init_moe_block(gen, cfg: ArchConfig, device):
    if cfg.mla:
        a = attn.init_mla(gen, cfg.d_model, cfg.n_heads, q_rank=cfg.q_rank,
                          kv_rank=cfg.kv_rank, qk_nope=cfg.qk_nope,
                          qk_rope=cfg.qk_rope, v_dim=cfg.v_head_dim,
                          dtype=cfg.p_dtype, device=device)
    else:
        a = attn.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.p_dtype, cfg.qkv_bias, device)
    return {
        "ln1": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "attn": a,
        "ln2": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "moe": moe_lib.init_moe(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                cfg.n_experts, cfg.n_shared_experts,
                                gated=cfg.mlp_gated, dtype=cfg.p_dtype,
                                device=device),
    }


def _init_mamba_block(gen, cfg: ArchConfig, device):
    return {
        "ln": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "mixer": ssm_lib.init_mamba2(gen, cfg.d_model, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand,
                                     head_dim=cfg.ssm_head_dim,
                                     conv_width=cfg.conv_width,
                                     dtype=cfg.p_dtype, device=device),
    }


def _init_xlstm_block(gen, cfg: ArchConfig, kind: str, device):
    if kind == "s":
        return xlstm_lib.init_slstm(gen, cfg.d_model, cfg.n_heads,
                                    cfg.p_dtype, device)
    return xlstm_lib.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                proj_factor=cfg.mlstm_proj_factor,
                                dtype=cfg.p_dtype, device=device)


def _mtp_block_cfg(cfg: ArchConfig) -> ArchConfig:
    """The MTP head's dense block: MHA (no MLA) with d_ff = max(moe_d_ff
    or d_ff, d_ff)."""
    return cfg.replace(mla=False, d_ff=max(cfg.moe_d_ff or cfg.d_ff,
                                           cfg.d_ff))


def init_params(gen: Optional[torch.Generator], cfg: ArchConfig,
                device="cuda"):
    """Random params from ``gen`` (a generator on ``device``). On the
    ``meta`` device ``gen`` may be None: shapes only, for counting. The
    tree is the JAX package's: ``frontend_proj`` (audio) or ``embed`` (and
    the vision ``projector``), the stacked ``blocks`` (and Zamba2's
    ``shared_attn``) or xLSTM's ``blocks_list``, the ``mtp`` head when
    ``cfg.mtp``, ``final_norm``, and ``lm_head`` unless the embeddings are
    tied (audio always has one)."""
    _check_family(cfg)
    device = resolve_device(device)
    pd = cfg.p_dtype
    params = {}
    if cfg.frontend == "audio":
        params["frontend_proj"] = dense_init(gen, cfg.frontend_dim,
                                             cfg.d_model, pd, device)
    else:
        params["embed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, pd,
                                     device)
        if cfg.frontend == "vision":
            params["projector"] = {
                "w1": dense_init(gen, cfg.frontend_dim, cfg.d_model, pd,
                                 device),
                "w2": dense_init(gen, cfg.d_model, cfg.d_model, pd, device),
            }
    if cfg.family == "ssm":
        if len(cfg.xlstm_pattern) != cfg.n_layers:
            raise ValueError(f"xlstm_pattern {cfg.xlstm_pattern} has not "
                             f"n_layers={cfg.n_layers} entries")
        params["blocks_list"] = [_init_xlstm_block(gen, cfg, kind, device)
                                 for kind in cfg.xlstm_pattern]
    else:
        init_block = {"dense": _init_dense_block, "vlm": _init_dense_block,
                      "audio": _init_dense_block, "moe": _init_moe_block,
                      "hybrid": _init_mamba_block}[cfg.family]
        params["blocks"] = tree_stack([init_block(gen, cfg, device)
                                       for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_block(gen, cfg, device)
    if cfg.mtp:
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, pd, device),
            "norm_h": init_rmsnorm(cfg.d_model, pd, device),
            "norm_e": init_rmsnorm(cfg.d_model, pd, device),
            "block": _init_dense_block(gen, _mtp_block_cfg(cfg), device),
        }
    params["final_norm"] = init_rmsnorm(cfg.d_model, pd, device)
    if cfg.family == "audio" or not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       pd, device)
    return params


# ===========================================================================
# Block forwards
# ===========================================================================

def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=cfg.window)


def _sub(tp, key: str):
    return None if tp is None else tp.sub(key)


def _dense_block_fwd(cfg: ArchConfig, p, x, positions, tp=None):
    h = x + attn.attention_fwd(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                               causal=cfg.causal, positions=positions,
                               tp=_sub(tp, "attn"), **_attn_kw(cfg))
    return h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                         cfg.mlp_act, _sub(tp, "mlp"))


def _mla_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                v_dim=cfg.v_head_dim, kv_rank=cfg.kv_rank,
                rope_theta=cfg.rope_theta, window=cfg.window)


def _moe_block_fwd(cfg: ArchConfig, p, x, positions, tp=None):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        a = attn.mla_fwd(p["attn"], xn, causal=cfg.causal,
                         positions=positions, q_chunk=cfg.attn_q_chunk,
                         remat=cfg.remat, tp=_sub(tp, "attn"),
                         **_mla_kw(cfg))
    else:
        a = attn.attention_fwd(p["attn"], xn, causal=cfg.causal,
                               positions=positions, tp=_sub(tp, "attn"),
                               **_attn_kw(cfg))
    h = x + a
    moe_fn = (moe_lib.moe_apply_grouped if cfg.moe_impl == "grouped"
              else moe_lib.moe_apply)
    y, aux = moe_fn(p["moe"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                    top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                    act=cfg.mlp_act, tp=_sub(tp, "moe"))
    return h + y, aux


def _mamba_block_fwd(cfg: ArchConfig, p, x, tp=None):
    return x + ssm_lib.mamba2_fwd(
        p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), d_state=cfg.ssm_state,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk,
        tp=_sub(tp, "mixer"))


def _xlstm_block_fwd(cfg: ArchConfig, kind: str, p, x):
    if kind == "s":
        return xlstm_lib.slstm_block_fwd(p, x, n_heads=cfg.n_heads,
                                         chunk=cfg.xlstm_chunk,
                                         remat=cfg.remat)
    return xlstm_lib.mlstm_block_fwd(p, x, n_heads=cfg.n_heads,
                                     proj_factor=cfg.mlstm_proj_factor,
                                     chunk=cfg.xlstm_chunk,
                                     impl=cfg.mlstm_impl, remat=cfg.remat)


def _pattern_period(pattern) -> int:
    """Smallest p such that pattern repeats every p layers."""
    L = len(pattern)
    for p in range(1, L + 1):
        if L % p == 0 and pattern == pattern[:p] * (L // p):
            return p
    return L


# ===========================================================================
# Full forward (prefill)
# ===========================================================================

def _embed_tokens(params, cfg: ArchConfig, tokens, tp=None):
    """Token embeddings in the activation dtype; Gemma's scale √d_model is
    rounded to that dtype first, as the JAX package multiplies by
    ``jnp.asarray(d ** 0.5, act_dtype)`` (bf16: 45.25, not 45.2548…), and
    applied after a vocab-parallel lookup's sum."""
    tok = embed_lookup(params["embed"], tokens, cfg.act_dtype, tp)
    if cfg.embed_scale:
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.act_dtype)
        tok = tok * scale.item()
    return tok


def embed_inputs(params, cfg: ArchConfig, batch, tp=None):
    """Returns (hidden (B,S,D), positions (B,S) or None). Audio reads
    ``batch["frames"]`` (B, S, frontend_dim); a VLM puts the projected
    ``batch["patch_embeds"]`` (B, P, frontend_dim) before the text."""
    _check_family(cfg)
    dt = cfg.act_dtype
    if cfg.family == "audio":
        return batch["frames"].to(dt) @ params["frontend_proj"].to(dt), None
    tok = _embed_tokens(params, cfg, batch["tokens"], tp)
    if cfg.family == "vlm":
        proj = params["projector"]
        pe = batch["patch_embeds"].to(dt) @ proj["w1"].to(dt)
        pe = F.gelu(pe, approximate="tanh") @ proj["w2"].to(dt)
        tok = torch.cat([pe, tok], dim=1)
    return tok, None


def _logits(params, cfg: ArchConfig, h, tp=None):
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    name = _head_name(cfg)
    return vocab_logits(h, params[name], name, tp)


def _head_name(cfg: ArchConfig) -> str:
    return ("embed" if cfg.tie_embeddings and cfg.family != "audio"
            else "lm_head")


def _unstacked(specs):
    """The specs of one layer of a stacked tree (the layer dim dropped)."""
    if isinstance(specs, dict):
        return {k: _unstacked(v) for k, v in specs.items()}
    return specs[1:]


@functools.lru_cache(maxsize=64)
def _layout_specs(cfg: ArchConfig, mp: int, fsdp: bool, moe_2d: bool):
    """``param_specs`` of the whole tree (its shapes on ``meta``) at a
    model axis of ``mp``: a layout that splits over "data" reads the
    whole leaves' dims, which a rank's blocks do not show."""
    return sh.param_specs(init_params(None, cfg, "meta"), cfg, mp=mp,
                          fsdp_axis="data" if fsdp else None, moe_2d=moe_2d)


def _model_axis(cfg: ArchConfig, mesh, rows: int, global_batch, *,
                fsdp: bool = False, moe_2d: bool = False):
    """The top-level ``ModelAxis`` of a rank's params on ``mesh`` (None
    without one). ``rows``: the batch rows the rank holds; the batch is
    split over the data slices unless ``global_batch`` equals them (by
    default it is ``rows`` times the data slices: ``data_specs``'s split
    of a batch they divide). ``fsdp`` / ``moe_2d``: the params' layout."""
    if mesh is None:
        return None
    if getattr(mesh, "model_shards", None) is None:
        raise TypeError(f"mesh must be a launch.mesh.FedMesh, not "
                        f"{type(mesh).__name__}")
    gb = rows * mesh.data_shards if global_batch is None else global_batch
    return ModelAxis(mesh, _layout_specs(cfg, mesh.model_shards, fsdp,
                                         moe_2d),
                     data_split=int(gb) != int(rows))


def _block_axis(tp):
    """The axis with the specs of one layer of ``params["blocks"]``."""
    return None if tp is None else tp.with_specs(
        _unstacked(tp.specs["blocks"]))


def _top_whole(params, tp):
    """``params`` with every leaf outside the layer stack that the specs
    split over "data" (ZeRO-3) gathered whole over the data axis, once for
    the call (a tied embedding is gathered once for its two uses)."""
    if tp is None:
        return params
    return {k: v if k in ("blocks", "blocks_list") else
            tp.whole(v, tp.specs[k]) for k, v in params.items()}


def _stack_whole(blocks, specs, tp):
    """The stacked layer leaves that the specs split over "data" on the
    layer dim, gathered whole before the unbind (``_layers``); the others
    are gathered a layer at a time where the layer runs."""
    if isinstance(blocks, dict):
        return {k: _stack_whole(v, specs[k], tp) for k, v in blocks.items()}
    return tp.fsdp_gather(blocks, 0) if data_dim(specs) == 0 else blocks


def _whole(tp, p):
    """A layer's params with its leaves split over "data" gathered."""
    return p if tp is None else tp.whole(p)


def _remat(cfg: ArchConfig, fn, *args):
    """fn(*args), under ``torch.utils.checkpoint`` when ``cfg.remat`` is set
    and grad is enabled (the reference's ``jax.checkpoint``): the same
    values, with only the inputs kept for the backward, which runs fn
    again."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layers(blocks, n: int) -> list:
    """The stacked layer params as n per-layer dicts of views. One unbind
    a leaf: its backward stacks the layers' gradients once, where a
    select per layer would add a zero-filled copy of the whole stack's
    gradient for every layer."""
    if isinstance(blocks, dict):
        per = {k: _layers(v, n) for k, v in blocks.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(blocks.unbind(0))


def _hidden(params, cfg: ArchConfig, batch, tp):
    """The layer stack over the embedded inputs: -> (hidden (B, S, D)
    before the final norm, aux: the MoE family's aux losses, the layers'
    means). ``params``: ``_top_whole``'s. Each layer body is
    checkpointed with ``cfg.remat`` and grad enabled; under ZeRO-3 it
    gathers its params inside, so a recompute gathers them again."""
    x, _ = embed_inputs(params, cfg, batch, tp)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = {"load_balance_loss": torch.zeros((), device=x.device),
           "router_z_loss": torch.zeros((), device=x.device)}
    bt = _block_axis(tp) if "blocks" in params else None
    blocks = params.get("blocks")
    if bt is not None:
        blocks = _stack_whole(blocks, tp.specs["blocks"], tp)
    if cfg.family in ("dense", "vlm", "audio"):
        def body(h, p):
            return _dense_block_fwd(cfg, _whole(bt, p), h, positions, bt)
        for p in _layers(blocks, cfg.n_layers):
            x = _remat(cfg, body, x, p)
    elif cfg.family == "moe":
        def body(h, p):
            h, a = _moe_block_fwd(cfg, _whole(bt, p), h, positions, bt)
            return h, a.load_balance_loss, a.router_z_loss
        lb, zl = [], []
        for p in _layers(blocks, cfg.n_layers):
            x, lb_i, zl_i = _remat(cfg, body, x, p)
            lb.append(lb_i)
            zl.append(zl_i)
        aux["load_balance_loss"] = torch.mean(torch.stack(lb))
        aux["router_z_loss"] = torch.mean(torch.stack(zl))
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        st = _sub(tp, "shared_attn")
        period = cfg.shared_attn_period

        def body(h, p, shared_app: bool):
            h = _mamba_block_fwd(cfg, _whole(bt, p), h, bt)
            if shared_app:
                h = _dense_block_fwd(cfg, shared, h, positions, st)
            return h
        for i, p in enumerate(_layers(blocks, cfg.n_layers)):
            x = _remat(cfg, body, x, p,
                       period > 0 and (i + 1) % period == 0)
    else:                                                   # ssm (xLSTM)
        pattern, blocks = cfg.xlstm_pattern, params["blocks_list"]

        def block(h, i):
            p = blocks[i] if tp is None else tp.whole(
                blocks[i], tp.specs["blocks_list"][i])
            return _xlstm_block_fwd(cfg, pattern[i], p, h)

        # xlstm_scan_units: the JAX package scans n_layers / period units,
        # each checkpointed around its blocks' own checkpoints, to bound
        # its backward's live buffers to one unit; units run in layer
        # order, so here they are the same loop, nested the same way
        period = _pattern_period(pattern)
        if cfg.xlstm_scan_units and period < cfg.n_layers:
            def unit(h, u):
                for i in range(u * period, (u + 1) * period):
                    h = _remat(cfg, block, h, i)
                return h
            for u in range(cfg.n_layers // period):
                x = _remat(cfg, unit, x, u)
        else:
            for i in range(cfg.n_layers):
                x = _remat(cfg, block, x, i)
    return x, aux


def forward(params, cfg: ArchConfig, batch, return_hidden: bool = False, *,
            mesh=None, global_batch: Optional[int] = None,
            fsdp: bool = False):
    """-> (logits (B,S,V), aux dict). return_hidden adds aux['hidden'].
    ``batch["tokens"]``: (B, S) integer tensor on the params' device (or
    ``"frames"``, or ``"patch_embeds"`` with the text, as the family
    reads them). The MoE family's aux losses are the layers' means. With
    ``cfg.remat`` and grad enabled, each layer body is checkpointed.

    With ``mesh`` (a ``FedMesh``): ``params`` are the rank's blocks
    (``shard_params``; with ``fsdp`` also split over "data":
    ``sharding.specs.param_specs(fsdp_axis="data")``) and ``batch`` its
    rows (the whole batch when the data slices do not divide it: pass
    ``global_batch``, the batch's rows, when it is not B times the data
    slices); the logits are the rank's rows, whole over the vocab."""
    first = next(iter(batch.values()))
    tp = _model_axis(cfg, mesh, first.shape[0], global_batch,
                     fsdp=fsdp)
    params = _top_whole(params, tp)
    x, aux = _hidden(params, cfg, batch, tp)
    if return_hidden:
        aux["hidden"] = x
    return _logits(params, cfg, x, tp), aux


def _mtp_hidden(params, cfg: ArchConfig, hidden, tokens, tp):
    """The MTP head's dense block's output (before the final norm)."""
    mtp = params["mtp"]
    h = rmsnorm(mtp["norm_h"], hidden[:, :-1], cfg.norm_eps)
    e = embed_lookup(params["embed"], tokens[:, 1:], hidden.dtype, tp)
    e = rmsnorm(mtp["norm_e"], e, cfg.norm_eps)
    x = torch.cat([h, e], dim=-1) @ mtp["proj"].to(hidden.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _dense_block_fwd(cfg.replace(mla=False), mtp["block"], x,
                            positions, _sub(_sub(tp, "mtp"), "block"))


def mtp_logits(params, cfg: ArchConfig, hidden, tokens, *, mesh=None,
               global_batch: Optional[int] = None, fsdp: bool = False):
    """DeepSeek-V3's multi-token-prediction head (one extra depth):
    position t joins its final hidden state (``forward(...,
    return_hidden=True)``'s, before the final norm) with the embedding of
    token t+1 (not scaled) to predict token t+2, through one dense block
    at positions 0..S−2. hidden: (B, S, D); tokens: (B, S). Returns logits
    (B, S−1, V). ``mesh`` / ``global_batch`` / ``fsdp`` as
    ``forward``'s."""
    tp = _model_axis(cfg, mesh, tokens.shape[0], global_batch,
                     fsdp=fsdp)
    params = _top_whole(params, tp)
    return _logits(params, cfg, _mtp_hidden(params, cfg, hidden, tokens,
                                            tp), tp)


def shard_params(params, cfg: ArchConfig, mesh, *, fsdp: bool = False):
    """The rank's blocks of a whole param tree on ``mesh``: each leaf cut
    by ``sharding.specs.param_specs(params, cfg, mp=M)``, M the model
    axis (a leaf the specs replicate stays whole, the same tensor); with
    ``fsdp`` also over "data" (``fsdp_axis="data"``). Refuses a model axis
    that splits Mamba2's d_inner but not its heads."""
    _check_heads(cfg, mesh)
    return sh.tree_blocks(params, sh.param_specs(
        params, cfg, mp=mesh.model_shards,
        fsdp_axis="data" if fsdp else None), mesh)


# ===========================================================================
# Loss / train step
# ===========================================================================

def _ce_sum(logits, labels):
    """(the fp32 cross-entropy summed over the labels >= 0, their count)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    ce = -torch.take_along_dim(torch.log_softmax(logits.float(), -1),
                               safe[..., None], dim=-1)[..., 0]
    return torch.sum(ce * mask), torch.sum(mask)


def _ce(params, cfg: ArchConfig, x, labels, tp):
    """Mean cross-entropy in fp32 of the head on hidden ``x`` (before the
    final norm; its last ``labels.shape[1]`` positions) over the labels
    >= 0. Under a mesh: vocab-parallel where the specs split the head (the
    logits never gathered), the mean over the whole batch's labels where
    the batch is split over the data slices (the count summed over them,
    each rank's term its rows' sum over it, summed over them: a data sum
    whose backward is the identity)."""
    name = _head_name(cfg)
    L = labels.shape[1]
    if tp is not None and tp.split(name):
        h = rmsnorm(params["final_norm"], x[:, -L:], cfg.norm_eps)
        s, n = vocab_ce_sum(tp.enter(h), params[name], name, labels, tp)
    else:
        s, n = _ce_sum(_logits(params, cfg, x, tp)[:, -L:], labels)
    if tp is None or not tp.data_split:
        return s / torch.clamp(n, min=1)
    n = tp.mesh.data_sum(n.clone())
    return tp.data_sum(s / torch.clamp(n, min=1))


def _loss(params, cfg: ArchConfig, batch, tp):
    """``loss_fn`` through ``tp`` (None: one device's whole params)."""
    params = _top_whole(params, tp)
    x, aux = _hidden(params, cfg, batch, tp)
    labels = batch["labels"]
    ce = _ce(params, cfg, x, labels, tp)
    total = (ce + cfg.aux_loss_weight * aux["load_balance_loss"]
             + cfg.z_loss_weight * aux["router_z_loss"])
    metrics = {"ce": ce}
    if cfg.mtp:
        mtp_ce = _ce(params, cfg, _mtp_hidden(params, cfg, x,
                                              batch["tokens"], tp),
                     labels[:, 1:], tp)
        total = total + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, {**metrics, **aux}


def _splits_model(specs) -> bool:
    return any(e == sh.MP_AXIS or (isinstance(e, tuple) and sh.MP_AXIS in e)
               for _, spec in sh.spec_items(specs) for e in spec)


def _train_axis(params, cfg: ArchConfig, mesh, batch, global_batch, *,
                fsdp: bool, moe_2d: bool, batch_over_model: bool):
    """(the top-level ``ModelAxis``, the batch the rank computes) of a
    train step on ``mesh`` ((None, ``batch``) without one). With
    ``batch_over_model`` the rank holds its rows of the batch split over
    the data and model axes: where a leaf is split over "model" the model
    group's rows are gathered (the slice's, then the plain path); where
    none is, the world is a data mesh of every rank (``FedMesh.flat``). A
    batch the axes do not divide is
    whole on every rank (pass ``global_batch`` when it is not the rows
    times the axes' ranks)."""
    if mesh is None:
        return None, batch
    if getattr(mesh, "model_shards", None) is None:
        raise TypeError(f"mesh must be a launch.mesh.FedMesh, not "
                        f"{type(mesh).__name__}")
    M = mesh.model_shards
    specs = _layout_specs(cfg, M, fsdp, moe_2d)
    rows = next(iter(batch.values())).shape[0]
    over = mesh.data_shards * (M if batch_over_model else 1)
    gb = rows * over if global_batch is None else int(global_batch)
    if batch_over_model and gb != rows:
        if M > 1 and _splits_model(specs):
            batch = {k: mesh.model_gather(v.contiguous(), 0)
                     for k, v in batch.items()}
            rows *= M
        else:
            mesh = mesh.flat()
    return ModelAxis(mesh, specs, data_split=gb != rows), batch


def loss_fn(params, cfg: ArchConfig, batch, mesh=None, *,
            global_batch: Optional[int] = None, fsdp: bool = False,
            moe_2d: bool = False, batch_over_model: bool = False):
    """-> (total loss, metrics): the cross-entropy of ``batch["labels"]``
    (B, S_text; < 0 masked; a VLM's on its last S_text positions, the
    text), plus ``aux_loss_weight`` × load balance and ``z_loss_weight`` ×
    router z-loss, and with ``cfg.mtp`` ``mtp_weight`` × the MTP head's
    cross-entropy on ``labels[:, 1:]``. Metrics: ``ce`` (``mtp_ce``),
    ``load_balance_loss``, ``router_z_loss``.

    With ``mesh``: ``params`` are the rank's blocks (with ``fsdp`` /
    ``moe_2d`` in that layout), ``batch`` its rows (``data_specs``, with
    ``batch_over_model`` over the model axis too); the loss and metrics
    are the whole batch's, and the backward through them gives each leaf
    its block's gradient, whole over the model group, to be summed over
    the data slices (``train_step`` does)."""
    tp, batch = _train_axis(params, cfg, mesh, batch, global_batch,
                            fsdp=fsdp, moe_2d=moe_2d,
                            batch_over_model=batch_over_model)
    return _loss(params, cfg, batch, tp)


def _state_specs(cfg: ArchConfig, mesh, zero: bool, fsdp: bool,
                 moe_2d: bool) -> dict:
    """``sharding.specs.state_specs`` at the mesh's model axis, read off
    the whole tree's shapes."""
    whole = init_params(None, cfg, "meta")
    return sh.state_specs({"params": whole, "mu": whole}, cfg,
                          mp=mesh.model_shards, zero=zero, fsdp=fsdp,
                          moe_2d=moe_2d)


def _check_heads(cfg: ArchConfig, mesh):
    """Refuses a model axis that splits Mamba2's d_inner but not its
    heads."""
    M = mesh.model_shards
    di = cfg.ssm_expand * cfg.d_model
    if cfg.family == "hybrid" and M > 1 and di % M == 0:
        ssm_lib.local_heads(di, cfg.ssm_head_dim, M)


def init_train_state(gen: Optional[torch.Generator], cfg: ArchConfig,
                     device="cuda", *, mesh=None, zero: bool = False,
                     fsdp: bool = False, moe_2d: bool = False):
    """{"params", "mu", "nu", "step"}: ``init_params``, fp32 zeros of the
    params' shapes for both moments, and an int32 step of 0. With
    ``mesh``: the rank's blocks by ``sharding.specs.state_specs(mp=M,
    zero=, fsdp=, moe_2d=)`` (the whole params drawn, then cut; the
    moments made as blocks)."""
    device = resolve_device(device)
    params = init_params(gen, cfg, device)
    if mesh is not None:
        _check_heads(cfg, mesh)
        ss = _state_specs(cfg, mesh, zero, fsdp, moe_2d)
        mom = _zero_blocks(tree_map(lambda p: p.float(), init_params(
            None, cfg, "meta")), ss["mu"], mesh, device)
        return {"params": sh.tree_blocks(params, ss["params"], mesh),
                "mu": mom, "nu": tree_map(torch.zeros_like, mom),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    return {"params": params, "mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def shard_state(state, cfg: ArchConfig, mesh, *, zero: bool = False,
                fsdp: bool = False, moe_2d: bool = False):
    """The rank's blocks of a whole train state on ``mesh`` by
    ``sharding.specs.state_specs(mp=M, zero=, fsdp=, moe_2d=)`` (a leaf
    the specs replicate stays the same tensor). A spec whose axes do not
    divide its dim on the mesh raises ``ValueError``."""
    _check_heads(cfg, mesh)
    return sh.tree_blocks(state, _state_specs(cfg, mesh, zero, fsdp,
                                              moe_2d), mesh)


ADAM_SLICE = 1 << 24         # elements a slice of the in-place update


def _spec_leaves(specs) -> list:
    """A spec tree's specs in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _has_data(spec) -> bool:
    return any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for e in spec)


def _adamw_(p, g, mu, nu, step, cfg: ArchConfig, b1, b2, eps):
    """``adamw_update`` in place on ``p``, ``mu``, ``nu`` (same shapes,
    contiguous), in slices of ``ADAM_SLICE`` elements (on ``meta``, one)."""
    pf, gf, mf, nf = p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1)
    n_sl = max(pf.numel(), 1) if pf.is_meta else ADAM_SLICE
    for lo in range(0, pf.numel(), n_sl):
        sl = slice(lo, lo + n_sl)
        new_p, opt = adamw_update(
            {"w": pf[sl]}, {"w": gf[sl]},
            {"mu": {"w": mf[sl]}, "nu": {"w": nf[sl]}, "step": step},
            cfg.lr, b1=b1, b2=b2, eps=eps, weight_decay=cfg.weight_decay)
        pf[sl].copy_(new_p["w"])
        mf[sl].copy_(opt["mu"]["w"])
        nf[sl].copy_(opt["nu"]["w"])


def loss_and_grads(params, cfg: ArchConfig, batch, mesh=None, *,
                   global_batch: Optional[int] = None, fsdp: bool = False,
                   moe_2d: bool = False, batch_over_model: bool = False):
    """-> (loss, metrics, grads): ``loss_fn``'s, detached, and the gradient
    of every leaf of ``params`` in ``tree_leaves`` order (zeros for an
    unused one). With ``mesh`` (``loss_fn``'s arguments) each gradient is
    the block's whole one: summed over the data slices (one
    ``all_reduce`` a leaf, fp32 on the wire) where the batch is split over
    them, but for a leaf split over "data", whose gather's backward summed
    it."""
    tp, batch = _train_axis(params, cfg, mesh, batch, global_batch,
                            fsdp=fsdp, moe_2d=moe_2d,
                            batch_over_model=batch_over_model)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = _loss(params, cfg, batch, tp)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                             materialize_grads=True))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if tp is not None and tp.data_split:
        with torch.no_grad():
            for i, spec in enumerate(_spec_leaves(tp.specs)):
                if not _has_data(spec):
                    g = grads[i]
                    grads[i] = tp.mesh.data_sum(g.float()).to(g.dtype)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        grads


def train_step(state, batch, cfg: ArchConfig, b1=0.9, b2=0.95, eps=1e-8,
               mesh=None, *, global_batch: Optional[int] = None,
               zero: bool = False, fsdp: bool = False, moe_2d: bool = False,
               batch_over_model: bool = False):
    """One AdamW step on the gradients of ``loss_fn``; returns (state,
    metrics: ``loss`` and ``loss_fn``'s). The update is
    ``optim.solvers.adamw_update`` (bias correction, eps outside the sqrt,
    decoupled weight decay in fp32, fp32 moments, params cast back to their
    dtype), applied IN PLACE to ``state``'s params, ``mu`` and ``nu``, leaf
    by leaf in the reference's leaf order, in slices of ``ADAM_SLICE``
    elements, each gradient freed once used: a functional update would
    hold a second copy of params and moments (16 bytes a param; 40 GB for
    Gemma-2B). On ``meta`` (the dry run: no memory to bound) a leaf is
    one slice. ``state["step"]`` becomes step + 1.

    With ``mesh``: ``state`` is the rank's blocks (``init_train_state(...,
    mesh=)`` / ``shard_state`` with the same ``zero`` / ``fsdp`` /
    ``moe_2d``), ``batch`` its rows (``loss_fn``'s), the gradients
    ``loss_and_grads``'. With ``zero`` a rank updates its block of each
    parameter (the moments' block over "data") and the data axis gathers
    the parameter back: AdamW is elementwise, so this is the plain step's
    update exactly."""
    loss, metrics, grads = loss_and_grads(
        state["params"], cfg, batch, mesh, global_batch=global_batch,
        fsdp=fsdp, moe_2d=moe_2d, batch_over_model=batch_over_model)
    leaves = tree_leaves(state["params"])
    m_specs = [None] * len(leaves)
    if mesh is not None and zero and not fsdp:
        m_specs = _spec_leaves(_layout_specs(cfg, mesh.model_shards, True,
                                             moe_2d))
    step = state["step"]
    with torch.no_grad():
        for i, (p, mu, nu) in enumerate(zip(leaves, tree_leaves(state["mu"]),
                                            tree_leaves(state["nu"]))):
            g, grads[i] = grads[i], None
            k = None if m_specs[i] is None else data_dim(m_specs[i])
            if k is None or mu.shape == p.shape:
                _adamw_(p, g, mu, nu, step, cfg, b1, b2, eps)
                continue
            # ZeRO-1: the rank's block of the parameter, then gathered
            b = mu.shape[k]
            lo = mesh.fsdp_index * b
            blk = p.narrow(k, lo, b).contiguous()
            _adamw_(blk, g.narrow(k, lo, b), mu, nu, step, cfg, b1, b2, eps)
            wire = blk.float() if blk.dtype != torch.float32 else blk
            p.copy_(mesh.fsdp_gather(wire, k))
    state["step"] = step + 1
    return state, {"loss": loss, **metrics}


# ===========================================================================
# Decode: cache init + serve_step
# ===========================================================================

def _stacked(tree, n: int):
    return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda", *,
               mesh=None, seq_shard: bool = False):
    """Decode caches: a KV cache per layer (dense, VLM, MoE), MLA's
    compressed ``c_kv`` (B, L, kv_rank) and ``k_pe`` (B, L, qk_rope) per
    layer, Zamba2's Mamba2 states and one KV cache per shared-block
    application, or xLSTM's per-layer states (``{"xlstm": [...]}``).
    ``max_len`` slots; with a window, a ring of ``max_len`` (== window)
    slots. With ``mesh``: the rank's blocks of the cache of ``batch``
    rows by ``sharding.specs.cache_specs(..., seq_shard=seq_shard)``."""
    _check_family(cfg)
    if mesh is not None:
        return _cache_blocks(cfg, batch, max_len, device, mesh, seq_shard)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.family} has no decode cache (encoder-only?)")
    device = resolve_device(device)
    dt = cfg.act_dtype
    if cfg.family == "ssm":
        return {"xlstm": [
            xlstm_lib.init_slstm_cache(batch, cfg.d_model, dt, device)
            if kind == "s" else xlstm_lib.init_mlstm_cache(
                batch, cfg.d_model, cfg.n_heads, cfg.mlstm_proj_factor, dt,
                device) for kind in cfg.xlstm_pattern]}
    if cfg.mla:
        return _stacked(attn.init_mla_cache(batch, max_len, cfg.kv_rank,
                                            cfg.qk_rope, dt, device),
                        cfg.n_layers)
    kv = attn.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dt,
                            device)
    if cfg.family in ("dense", "vlm", "moe"):
        return _stacked(kv, cfg.n_layers)
    m = ssm_lib.init_mamba2_cache(batch, cfg.d_model, d_state=cfg.ssm_state,
                                  expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim,
                                  conv_width=cfg.conv_width, dtype=dt,
                                  device=device)
    n_apps = (cfg.n_layers // cfg.shared_attn_period
              if cfg.shared_attn_period else 0)
    return {"mamba": _stacked(m, cfg.n_layers),
            "shared_attn": _stacked(kv, max(n_apps, 1))}


def _cache_blocks(cfg: ArchConfig, batch: int, max_len: int, device, mesh,
                  seq_shard: bool):
    whole = init_cache(cfg, batch, max_len, "meta")
    specs = sh.cache_specs(whole, cfg, mesh, mp=mesh.model_shards,
                           seq_shard=seq_shard)
    if cfg.family == "ssm":
        # xLSTM's states (not all zeros) are whole over the model axis:
        # the block is the cache of the rank's rows
        rows = sh.shard_shape(whole["xlstm"][0]["m"].shape,
                              specs["xlstm"][0]["m"], mesh)[0]
        return init_cache(cfg, rows, max_len, device)
    return _zero_blocks(whole, specs, mesh, resolve_device(device))


def _zero_blocks(whole, specs, mesh, device):
    """Zeros of the blocks' shapes (every cache but xLSTM's starts at
    zero; a train state's moments)."""
    if isinstance(whole, dict):
        return {k: _zero_blocks(v, specs[k], mesh, device)
                for k, v in whole.items()}
    if isinstance(whole, list):
        return [_zero_blocks(v, sp, mesh, device)
                for v, sp in zip(whole, specs)]
    return torch.zeros(sh.shard_shape(whole.shape, specs, mesh),
                       dtype=whole.dtype, device=device)


def _slot_split(kv_spec) -> bool:
    """Whether a layer's cache spec puts its slot dim (1) over the model
    axis (``cache_specs(seq_shard=True)``)."""
    if not isinstance(kv_spec, (tuple, list)) or len(kv_spec) < 2:
        raise ValueError(f"kv_spec {kv_spec!r} is not one layer's cache "
                         "spec (a tuple, an entry a dim)")
    e = kv_spec[1]
    return e == sh.MP_AXIS or (isinstance(e, tuple) and sh.MP_AXIS in e)


def serve_step(params, cfg: ArchConfig, cache, tokens, pos, kv_spec=None, *,
               mesh=None, global_batch: Optional[int] = None,
               fsdp: bool = False):
    """Decode ONE token. tokens: (B,1) integers; pos: (B,) absolute
    positions. Returns (logits (B, V), new_cache); ``cache`` is not
    changed. A VLM decodes text only.

    With ``mesh``: ``params`` and ``cache`` are the rank's blocks
    (``shard_params``, ``init_cache(mesh=)``), tokens and pos its rows
    (``global_batch`` as ``forward``'s). ``kv_spec``, the spec of one
    layer's attention cache (B, S, KV, hd) or MLA latent (B, S, r) as
    ``cache_specs`` places it, with its slot dim over the model axis
    selects the slot-split decode (the reference's sequence-sharded
    cache); it places a cache on a mesh, so it needs ``mesh``. ``fsdp``:
    the params are also split over "data" (``forward``'s)."""
    _check_family(cfg)
    if kv_spec is not None and mesh is None:
        raise ValueError(f"kv_spec={kv_spec!r} places the cache on a mesh: "
                         "pass mesh= (a FedMesh) with the rank's blocks")
    # a slot split over an axis of one rank is the whole cache
    seq = kv_spec is not None and _slot_split(kv_spec) and \
        mesh.model_shards > 1
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    tp = _model_axis(cfg, mesh, tokens.shape[0], global_batch,
                     fsdp=fsdp)
    params = _top_whole(params, tp)
    x = _embed_tokens(params, cfg, tokens, tp)
    if cfg.family == "ssm":
        new_list = []
        blocks = params["blocks_list"]
        if tp is not None:
            blocks = tp.whole(blocks, tp.specs["blocks_list"])
        for kind, p, c in zip(cfg.xlstm_pattern, blocks, cache["xlstm"]):
            if kind == "s":
                x, c2 = xlstm_lib.slstm_block_step(p, c, x,
                                                   n_heads=cfg.n_heads)
            else:
                x, c2 = xlstm_lib.mlstm_block_step(
                    p, c, x, n_heads=cfg.n_heads,
                    proj_factor=cfg.mlstm_proj_factor)
            new_list.append(c2)
        return _logits(params, cfg, x, tp)[:, 0], {"xlstm": new_list}
    blocks = params["blocks"]
    bt = _block_axis(tp)
    if tp is not None:
        blocks = _stack_whole(blocks, tp.specs["blocks"], tp)
    at = _sub(bt, "attn")
    akw = {} if tp is None else {"tp": at, "seq_shard": seq}
    if cfg.family in ("dense", "vlm", "moe"):
        new = []
        for i in range(cfg.n_layers):
            p = _whole(bt, tree_index(blocks, i))
            xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla:
                y, c2 = attn.mla_decode(p["attn"], tree_index(cache, i), xn,
                                        pos, **akw, **_mla_kw(cfg))
            else:
                y, c2 = attn.attention_decode(p["attn"], tree_index(cache, i),
                                              xn, pos, **akw, **_attn_kw(cfg))
            x = x + y
            xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            if cfg.family == "moe":
                # the scatter dispatch whatever ``moe_impl``, as the JAX
                # package decodes
                y, _ = moe_lib.moe_apply(p["moe"], xn, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor,
                                         act=cfg.mlp_act, tp=_sub(bt, "moe"))
                x = x + y
            else:
                x = x + mlp_apply(p["mlp"], xn, cfg.mlp_act, _sub(bt, "mlp"))
            new.append(c2)
        return _logits(params, cfg, x, tp)[:, 0], tree_stack(new)

    # hybrid: shared-attn applications each own a cache slot
    new_mamba, new_shared = [], []
    app = 0
    for i in range(cfg.n_layers):
        p = _whole(bt, tree_index(blocks, i))
        c = tree_index(cache["mamba"], i)
        y, c2 = ssm_lib.mamba2_step(p["mixer"], c,
                                    rmsnorm(p["ln"], x, cfg.norm_eps),
                                    d_state=cfg.ssm_state,
                                    expand=cfg.ssm_expand,
                                    head_dim=cfg.ssm_head_dim,
                                    tp=_sub(bt, "mixer"))
        x = x + y
        new_mamba.append(c2)
        if cfg.shared_attn_period and (i + 1) % cfg.shared_attn_period == 0:
            sp = params["shared_attn"]
            st = _sub(tp, "shared_attn")
            skw = {} if tp is None else {"tp": st.sub("attn"),
                                         "seq_shard": seq}
            sc = tree_index(cache["shared_attn"], app)
            y, sc2 = attn.attention_decode(
                sp["attn"], sc, rmsnorm(sp["ln1"], x, cfg.norm_eps), pos,
                **skw, **_attn_kw(cfg))
            x = x + y
            x = x + mlp_apply(sp["mlp"], rmsnorm(sp["ln2"], x, cfg.norm_eps),
                              cfg.mlp_act, _sub(st, "mlp"))
            new_shared.append(sc2)
            app += 1
    new_cache = {"mamba": tree_stack(new_mamba),
                 "shared_attn": tree_stack(new_shared) if new_shared
                 else cache["shared_attn"]}
    return _logits(params, cfg, x, tp)[:, 0], new_cache
