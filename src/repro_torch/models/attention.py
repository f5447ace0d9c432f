"""Attention blocks (``repro.models.attention``): MHA/GQA/MQA with RoPE,
sliding window and decode caches.

Shapes
  x            (B, S, D)
  q            (B, S, H, hd)
  k/v          (B, S, KV, hd)
  cache k/v    (B, Smax, KV, hd)   — ring buffer when windowed

``attention_fwd``'s core, from the RoPE'd q/k/v to the ``wo`` product, is
the sliding-window flash kernel (``kernels.swa_attention``): on CUDA it
launches, on the CPU its plain version runs. ``attention_decode`` attends
over a ring-buffer cache, which is not the kernel's contiguous layout, and
stays plain PyTorch (``sdpa`` with an additive −1e30 bias), as the JAX
package computes it outside any kernel too. MLA (``mla_fwd``,
``mla_decode``) is plain PyTorch einsums, as the JAX package computes it
outside any kernel: its q/k head dim (192) differs from v's (128).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models.modules import apply_rope, dense_init, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.float32, qkv_bias: bool = False, device="cpu"):
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA head repetition
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def sdpa(q, k, v, mask_bias, softmax_scale: float) -> torch.Tensor:
    """q:(B,Sq,H,hd) k,v:(B,Sk,H,hd) mask_bias:(Sq,Sk) or (B,1,Sq,Sk).
    Scores in fp32; the probabilities are cast to q's dtype before P·V,
    as in the JAX package."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * softmax_scale
    scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def make_mask_bias(sq: int, sk: int, *, causal: bool, window: int | None,
                   q_offset: int = 0, device="cpu") -> torch.Tensor:
    """Additive bias (sq, sk). q position i maps to absolute i + q_offset."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Full-sequence (training / prefill) attention
# ---------------------------------------------------------------------------

def _project_qkv(params, x, n_heads, n_kv, head_dim):
    B, S, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, S, n_kv, head_dim)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, S, n_kv, head_dim)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype).reshape(n_heads, head_dim)
        k = k + params["bk"].to(x.dtype).reshape(n_kv, head_dim)
        v = v + params["bv"].to(x.dtype).reshape(n_kv, head_dim)
    return q, k, v


def attention_fwd(params, x, *, n_heads: int, n_kv: int, head_dim: int,
                  rope_theta: float | None, causal: bool = True,
                  window: int | None = None, positions=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). The kernel reads k/v with KV heads
    directly (head h reads kv head h // (H/KV)): no repeated copy."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = swa_attention(q, k, v, window=window, causal=causal).to(x.dtype)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Decode-step attention with (optionally ring-buffer) KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                  device="cpu"):
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params, cache, x, pos, *, n_heads: int, n_kv: int,
                     head_dim: int, rope_theta: float | None,
                     window: int | None = None):
    """One-token decode. x:(B,1,D), pos:(B,) absolute position of the new
    token. Returns (y (B,1,D), new cache); the old cache is not changed.

    Cache holds ``max_len`` slots. If ``window`` is set the cache is a ring
    buffer of size max_len (== window) indexed by pos % max_len; otherwise
    the cache is positional (slot == pos)."""
    B = x.shape[0]
    max_len = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)

    slot = pos % max_len if window is not None else pos
    bidx = torch.arange(B, device=x.device)
    new_k = cache["k"].clone()
    new_v = cache["v"].clone()
    new_k[bidx, slot] = k[:, 0]
    new_v[bidx, slot] = v[:, 0]

    kk = _repeat_kv(new_k, n_heads)
    vv = _repeat_kv(new_v, n_heads)
    # validity of each cache slot relative to the current position
    slots = torch.arange(max_len, device=x.device)[None, :]     # (1, Smax)
    if window is not None:
        # slot s holds the most recent position p <= pos with
        # p % max_len == s; valid iff p > pos - window and p >= 0
        delta = (slot[:, None] - slots) % max_len              # age of slot
        abs_pos = pos[:, None] - delta
        valid = (abs_pos >= 0) & (abs_pos > pos[:, None] - window)
    else:
        valid = slots <= pos[:, None]
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
    out = sdpa(q, kk, vv, bias, 1.0 / head_dim ** 0.5)
    y = out.reshape(B, 1, n_heads * head_dim) @ params["wo"].to(x.dtype)
    return y, {"k": new_k, "v": new_v}


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------
# Low-rank joint compression of q and kv. The decode cache stores only the
# compressed kv latent c_kv (rank r_kv) and the decoupled rope key k_pe.

def init_mla(gen, d_model: int, n_heads: int, *, q_rank: int, kv_rank: int,
             qk_nope: int, qk_rope: int, v_dim: int, dtype=torch.float32,
             device="cpu"):
    return {
        "w_dq": dense_init(gen, d_model, q_rank, dtype, device),
        "w_uq": dense_init(gen, q_rank, n_heads * (qk_nope + qk_rope), dtype,
                           device),
        "w_dkv": dense_init(gen, d_model, kv_rank + qk_rope, dtype, device),
        "w_uk": dense_init(gen, kv_rank, n_heads * qk_nope, dtype, device),
        "w_uv": dense_init(gen, kv_rank, n_heads * v_dim, dtype, device),
        "wo": dense_init(gen, n_heads * v_dim, d_model, dtype, device),
        "q_norm": {"scale": torch.ones((q_rank,), dtype=dtype,
                                       device=device)},
        "kv_norm": {"scale": torch.ones((kv_rank,), dtype=dtype,
                                        device=device)},
    }


def _mla_qkv(params, x, positions, *, n_heads, qk_nope, qk_rope, kv_rank,
             rope_theta):
    """(q_nope, q_pe, c_kv, k_pe). Both norms take rmsnorm's default eps
    (1e-6), as the JAX package; k_pe is roped with a singleton head axis."""
    B, S, _ = x.shape
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"].to(x.dtype))
    q = (cq @ params["w_uq"].to(x.dtype)).reshape(B, S, n_heads,
                                                  qk_nope + qk_rope)
    q_nope = q[..., :qk_nope]
    q_pe = apply_rope(q[..., qk_nope:], positions, rope_theta)
    dkv = x @ params["w_dkv"].to(x.dtype)
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :kv_rank])
    k_pe = apply_rope(dkv[..., kv_rank:][:, :, None, :], positions,
                      rope_theta)
    return q_nope, q_pe, c_kv, k_pe[:, :, 0, :]


def mla_fwd(params, x, *, n_heads: int, qk_nope: int, qk_rope: int,
            v_dim: int, kv_rank: int, rope_theta: float,
            causal: bool = True, window: int | None = None, positions=None,
            q_chunk: int | None = None, remat: bool = False):
    """x (B, S, D) -> (B, S, D). Scores in fp32 (the products of the
    activation dtype summed in fp32, as ``preferred_element_type``), masked
    by −1e30, probabilities cast to the activation dtype before P·V.
    ``q_chunk``: queries in chunks of that many rows, one after another, so
    the live scores are (B, H, q_chunk, S) instead of (B, H, S, S); with
    ``remat`` and grad enabled each chunk is ``torch.utils.checkpoint``ed
    (the reference's ``jax.checkpoint`` of a chunk), so its backward keeps
    no chunk's scores but the one it recomputes."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(
        params, x, positions, n_heads=n_heads, qk_nope=qk_nope,
        qk_rope=qk_rope, kv_rank=kv_rank, rope_theta=rope_theta)
    k_nope = (c_kv @ params["w_uk"].to(x.dtype)).reshape(B, S, n_heads,
                                                         qk_nope)
    v = (c_kv @ params["w_uv"].to(x.dtype)).reshape(B, S, n_heads, v_dim)
    scale = 1.0 / (qk_nope + qk_rope) ** 0.5
    k_nope32, k_pe32 = k_nope.float(), k_pe.float()

    def block(qn, qp, q_off):
        # in place: one (B, H, sq, S) fp32 buffer besides the softmax's
        s = torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope32)
        s += torch.einsum("bqhd,bkd->bhqk", qp.float(), k_pe32)
        s *= scale
        s += make_mask_bias(qn.shape[1], S, causal=causal, window=window,
                            q_offset=q_off, device=x.device)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    if q_chunk is None or S <= q_chunk:
        out = block(q_nope, q_pe, 0)
    else:
        if S % q_chunk:
            raise ValueError(f"mla_fwd: S={S} is not a multiple of "
                             f"q_chunk={q_chunk}")
        run = block
        if remat and torch.is_grad_enabled():
            def run(qn, qp, q_off):
                return checkpoint(block, qn, qp, q_off, use_reentrant=False)
        out = torch.cat([run(q_nope[:, i:i + q_chunk],
                             q_pe[:, i:i + q_chunk], i)
                         for i in range(0, S, q_chunk)], dim=1)
    return out.reshape(B, S, n_heads * v_dim) @ params["wo"].to(x.dtype)


def init_mla_cache(batch: int, max_len: int, kv_rank: int, qk_rope: int,
                   dtype, device="cpu"):
    return {"c_kv": torch.zeros((batch, max_len, kv_rank), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                                device=device)}


def mla_decode(params, cache, x, pos, *, n_heads: int, qk_nope: int,
               qk_rope: int, v_dim: int, kv_rank: int, rope_theta: float,
               window: int | None = None):
    """Absorbed-matrix MLA decode over the compressed cache: W_uk folds into
    the query and W_uv follows the latent P·V, so the cache never expands
    to per-head keys (DeepSeek-V3 §2.1). Returns (y (B,1,D), new cache);
    the old cache is not changed. Slot ``pos``, or ``pos % max_len`` with
    a window (a ring of ``max_len`` slots)."""
    B = x.shape[0]
    max_len = cache["c_kv"].shape[1]
    q_nope, q_pe, c_kv_new, k_pe_new = _mla_qkv(
        params, x, pos[:, None], n_heads=n_heads, qk_nope=qk_nope,
        qk_rope=qk_rope, kv_rank=kv_rank, rope_theta=rope_theta)

    slot = pos % max_len if window is not None else pos
    bidx = torch.arange(B, device=x.device)
    c_kv = cache["c_kv"].clone()
    k_pe = cache["k_pe"].clone()
    c_kv[bidx, slot] = c_kv_new[:, 0]
    k_pe[bidx, slot] = k_pe_new[:, 0]

    w_uk = params["w_uk"].to(x.dtype).reshape(kv_rank, n_heads, qk_nope)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    scale = 1.0 / (qk_nope + qk_rope) ** 0.5
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float())
              + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float())
              ) * scale
    slots = torch.arange(max_len, device=x.device)[None, :]
    if window is not None:
        delta = (slot[:, None] - slots) % max_len
        abs_pos = pos[:, None] - delta
        valid = (abs_pos >= 0) & (abs_pos > pos[:, None] - window)
    else:
        valid = slots <= pos[:, None]
    scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_kv)
    w_uv = params["w_uv"].to(x.dtype).reshape(kv_rank, n_heads, v_dim)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)
    y = out.reshape(B, 1, n_heads * v_dim) @ params["wo"].to(x.dtype)
    return y, {"c_kv": c_kv, "k_pe": k_pe}
