"""Architecture zoo (``repro.models.zoo``): ``ArchConfig`` whole, and the
hybrid family (Zamba2: Mamba2 backbone + one shared attention/MLP block)
for prefill (``forward``) and serving (``init_cache``, ``serve_step``).

Params are nested dicts with the JAX package's keys, stacked leaves for the
layer stack and ``(in, out)`` weights, so a JAX ``zoo.init_params`` tree
carries across with ``repro_torch.convert.params_from_numpy``. The layer
stack is a Python loop (the JAX ``lax.scan``); the shared block's
``lax.cond`` on ``(i + 1) % period == 0`` is a Python ``if``.

Not yet ported (each raises ``NotImplementedError`` naming its ROADMAP.md
item, queue 1): the dense/GQA family (17b), MoE/MLA and the MTP head
(17c), xLSTM (17d), the VLM and audio front ends (17e) and the training
step (``loss_fn``, ``train_step``; 17f).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.modules import (dense_init, embed_init, init_mlp,
                                        init_rmsnorm, mlp_apply, rmsnorm,
                                        tree_index, tree_map, tree_stack)


_ROADMAP_ITEM = {"dense": "17b", "moe": "17c", "ssm": "17d", "vlm": "17e",
                 "audio": "17e", "train": "17f"}


def _not_ported(what: str, kind: str):
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch: ROADMAP.md queue 1, item "
        f"{_ROADMAP_ITEM[kind]} (the model zoo; 17a ported the hybrid "
        "family)")


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


def _check_family(cfg: ArchConfig):
    if cfg.family != "hybrid":
        raise _not_ported(f"the {cfg.family!r} family ({cfg.name})",
                          cfg.family)
    if cfg.frontend != "none":
        raise _not_ported(f"{cfg.name}'s {cfg.frontend} front end", "vlm")
    if cfg.mtp:
        raise _not_ported(f"{cfg.name}'s MTP head", "moe")
    if cfg.tie_embeddings or cfg.embed_scale:
        raise _not_ported(f"{cfg.name}'s tied / scaled embeddings", "dense")


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


def _init_mamba_block(gen, cfg: ArchConfig, device):
    return {
        "ln": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "mixer": ssm_lib.init_mamba2(gen, cfg.d_model, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand,
                                     head_dim=cfg.ssm_head_dim,
                                     conv_width=cfg.conv_width,
                                     dtype=cfg.p_dtype, device=device),
    }


def init_params(gen: Optional[torch.Generator], cfg: ArchConfig,
                device="cuda"):
    """Random params from ``gen`` (a generator on ``device``). On the
    ``meta`` device ``gen`` may be None: shapes only, for counting."""
    _check_family(cfg)
    device = resolve_device(device)
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  cfg.p_dtype, device)}
    params["blocks"] = tree_stack([_init_mamba_block(gen, cfg, device)
                                   for _ in range(cfg.n_layers)])
    params["shared_attn"] = _init_dense_block(gen, cfg, device)
    params["final_norm"] = init_rmsnorm(cfg.d_model, cfg.p_dtype, device)
    params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                   cfg.p_dtype, device)
    return params


# ===========================================================================
# Block forwards
# ===========================================================================

def _dense_block_fwd(cfg: ArchConfig, p, x, positions):
    h = x + attn.attention_fwd(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.hd, rope_theta=cfg.rope_theta,
        causal=cfg.causal, window=cfg.window, positions=positions)
    return h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                         cfg.mlp_act)


def _mamba_block_fwd(cfg: ArchConfig, p, x):
    return x + ssm_lib.mamba2_fwd(
        p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), d_state=cfg.ssm_state,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk)


# ===========================================================================
# Full forward (prefill)
# ===========================================================================

def embed_inputs(params, cfg: ArchConfig, batch):
    """Returns (hidden (B,S,D), positions (B,S) or None)."""
    _check_family(cfg)
    return params["embed"].to(cfg.act_dtype)[batch["tokens"]], None


def _logits(params, cfg: ArchConfig, h):
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h @ params["lm_head"].to(h.dtype)


def forward(params, cfg: ArchConfig, batch, return_hidden: bool = False):
    """-> (logits (B,S,V), aux dict). return_hidden adds aux['hidden'].
    ``batch["tokens"]``: (B, S) integer tensor on the params' device."""
    x, _ = embed_inputs(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = {"load_balance_loss": torch.zeros((), device=x.device),
           "router_z_loss": torch.zeros((), device=x.device)}
    shared = params["shared_attn"]
    period = cfg.shared_attn_period
    for i in range(cfg.n_layers):
        x = _mamba_block_fwd(cfg, tree_index(params["blocks"], i), x)
        if period > 0 and (i + 1) % period == 0:
            x = _dense_block_fwd(cfg, shared, x, positions)
    if return_hidden:
        aux["hidden"] = x
    return _logits(params, cfg, x), aux


def loss_fn(*args, **kw):
    raise _not_ported("LM training (loss_fn / train_step, --mode lm)",
                      "train")


train_step = init_train_state = mtp_logits = loss_fn


# ===========================================================================
# Decode: cache init + serve_step
# ===========================================================================

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    _check_family(cfg)
    device = resolve_device(device)
    dt = cfg.act_dtype
    m = ssm_lib.init_mamba2_cache(batch, cfg.d_model, d_state=cfg.ssm_state,
                                  expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim,
                                  conv_width=cfg.conv_width, dtype=dt,
                                  device=device)
    mstack = tree_map(lambda a: a.expand((cfg.n_layers,) + a.shape).clone(),
                      m)
    n_apps = (cfg.n_layers // cfg.shared_attn_period
              if cfg.shared_attn_period else 0)
    sa = attn.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dt, device)
    sstack = tree_map(lambda a: a.expand((max(n_apps, 1),) + a.shape).clone(),
                      sa)
    return {"mamba": mstack, "shared_attn": sstack}


def serve_step(params, cfg: ArchConfig, cache, tokens, pos):
    """Decode ONE token. tokens: (B,1) integers; pos: (B,) absolute
    positions. Returns (logits (B, V), new_cache); ``cache`` is not
    changed."""
    _check_family(cfg)
    x = params["embed"].to(cfg.act_dtype)[tokens]
    # Python loop: shared-attn applications each own a cache slot
    new_mamba, new_shared = [], []
    app = 0
    for i in range(cfg.n_layers):
        p = tree_index(params["blocks"], i)
        c = tree_index(cache["mamba"], i)
        y, c2 = ssm_lib.mamba2_step(p["mixer"], c,
                                    rmsnorm(p["ln"], x, cfg.norm_eps),
                                    d_state=cfg.ssm_state,
                                    expand=cfg.ssm_expand,
                                    head_dim=cfg.ssm_head_dim)
        x = x + y
        new_mamba.append(c2)
        if cfg.shared_attn_period and (i + 1) % cfg.shared_attn_period == 0:
            sp = params["shared_attn"]
            sc = tree_index(cache["shared_attn"], app)
            y, sc2 = attn.attention_decode(
                sp["attn"], sc, rmsnorm(sp["ln1"], x, cfg.norm_eps), pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=cfg.window)
            x = x + y
            x = x + mlp_apply(sp["mlp"], rmsnorm(sp["ln2"], x, cfg.norm_eps),
                              cfg.mlp_act)
            new_shared.append(sc2)
            app += 1
    new_cache = {"mamba": tree_stack(new_mamba),
                 "shared_attn": tree_stack(new_shared) if new_shared
                 else cache["shared_attn"]}
    return _logits(params, cfg, x)[:, 0], new_cache
