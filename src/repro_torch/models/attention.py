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

Over a model axis (``tp``, a ``modules.ModelAxis``; the specs of
``sharding.specs._rule``) a rank computes its q heads (``wq``'s columns,
``wo``'s rows: a partial product summed over the model group) when the
axis divides the heads, else the whole layer with no collective. Its kv
heads are its own when the axis divides them too; else the kv projection
is whole and each q head reads the contiguous kv heads that cover the
rank's (``_kv_for_heads``: local head j is global head h0 + j, which reads
kv head (h0 + j) // (H / KV)). In training, what the group holds alike
enters the rank's own heads through ``ModelAxis.enter``: x, the cut 1-D
biases, whole k / v, and MLA's latent, rope key and summed q. A decode
cache whose slots are split over the axis (``seq_shard``, ``cache_specs(seq_shard=True)``) holds the rank's
S / M slots: the new token is written by the rank that owns its slot,
every rank scores all q heads against its slots, and the ranks' softmax
statistics merge by log-sum-exp (``_lse_merge``) before the row-parallel
``wo``. MLA splits ``w_dq`` over q_rank (its norm sums squares over the
group), ``w_uq`` over its rows (a sum), ``w_uk`` / ``w_uv`` / ``wo`` by
heads; its cache is split over the latent rank (the absorbed scores are
partial sums over it) or over the slots.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models.modules import (apply_rope, dense_init, rmsnorm,
                                        rmsnorm_split)

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

def _project_qkv(params, x, n_heads, n_kv, head_dim, h0: int = 0,
                 kv0: int = 0, tp=None, kv_local: bool = False):
    """q (B, S, n_heads, hd), k and v (B, S, n_kv, hd) from the (local)
    projections; the replicated 1-D biases are cut to the heads from
    ``h0`` and the kv heads from ``kv0``. With ``tp`` the q heads are the
    rank's own: ``x`` and ``bq`` enter its computation (``ModelAxis.
    enter``), and k / v too when ``kv_local`` (their heads split); whole
    k / v the caller enters before it cuts them."""
    B, S, _ = x.shape
    ent = (lambda t: t) if tp is None else tp.enter
    xl = ent(x)
    xk = xl if kv_local else x
    q = (xl @ params["wq"].to(x.dtype)).reshape(B, S, n_heads, head_dim)
    k = (xk @ params["wk"].to(x.dtype)).reshape(B, S, n_kv, head_dim)
    v = (xk @ params["wv"].to(x.dtype)).reshape(B, S, n_kv, head_dim)
    if "bq" in params:
        kent = ent if kv_local else (lambda t: t)
        qs = slice(h0 * head_dim, (h0 + n_heads) * head_dim)
        ks = slice(kv0 * head_dim, (kv0 + n_kv) * head_dim)
        q = q + ent(params["bq"])[qs].to(x.dtype).reshape(n_heads, head_dim)
        k = k + kent(params["bk"])[ks].to(x.dtype).reshape(n_kv, head_dim)
        v = v + kent(params["bv"])[ks].to(x.dtype).reshape(n_kv, head_dim)
    return q, k, v


def _local_heads(tp, n_heads: int, n_kv: int) -> tuple:
    """(q heads, first q head, kv heads, first kv head) of this rank:
    its block of each the axis splits, else all of them."""
    H, h0, KV, kv0 = n_heads, 0, n_kv, 0
    if tp is not None and tp.split("wq"):
        H = n_heads // tp.size
        h0 = tp.index * H
    if tp is not None and tp.split("wk"):
        KV = n_kv // tp.size
        kv0 = tp.index * KV
    return H, h0, KV, kv0


def _kv_for_heads(k: torch.Tensor, h0: int, n: int, n_heads: int,
                  n_kv: int) -> torch.Tensor:
    """The contiguous kv heads (dim 2 of a whole (B, S, KV, hd) k or v)
    read by q heads h0 .. h0 + n − 1 (head h reads kv head h // (H / KV)),
    so a kernel or ``_repeat_kv`` mapping local head j to local kv head
    j // (n / kv) maps them right: n and H / KV divide one another."""
    G = n_heads // n_kv
    if n % G and G % n:
        raise ValueError(f"{n} local heads and {G} heads a kv head do not "
                         "divide one another")
    lo = h0 // G
    return k[:, :, lo:lo + max(1, n // G)]


def _lse_merge(m, l, o, tp) -> torch.Tensor:
    """Softmax-weighted values over slots split across the model group:
    each rank's row max ``m`` and sum ``l`` (B, H, 1, 1) of exp(s − m) and
    its unnormalised ``o`` (B, 1, H, d), all fp32, stacked over the group
    (one gather) and merged in model-index order -> (B, 1, H, d) fp32, the
    same on every rank."""
    B, _, H, d = o.shape
    st = tp.stack(torch.cat([m.reshape(B, H, 1), l.reshape(B, H, 1),
                             o.reshape(B, H, d)], dim=2))    # (M, B, H, 2+d)
    ms, ls, os_ = st[..., :1], st[..., 1:2], st[..., 2:]
    w = torch.exp(ms - ms.amax(0))
    return ((os_ * w).sum(0) / (ls * w).sum(0))[:, None]


def _slot_valid(slots, slot, pos, max_len: int, window):
    """(B, n) validity of cache slots ``slots`` (global indices) for the
    token at ``pos`` written at ``slot``: a ring slot holds the latest
    position p <= pos with p % max_len == its index, valid when p > pos −
    window and p >= 0; a positional slot when its index <= pos."""
    if window is not None:
        delta = (slot[:, None] - slots) % max_len              # age of slot
        abs_pos = pos[:, None] - delta
        return (abs_pos >= 0) & (abs_pos > pos[:, None] - window)
    return slots <= pos[:, None]


def _write_slot(cache_leaf, new, slot, lo=None):
    """A copy of ``cache_leaf`` (B, n, ...) with ``new`` (B, ...) written
    at slot ``slot`` of each row; with ``lo`` the leaf holds the global
    slots lo .. lo + n − 1 (a slot-split cache) and only the rows whose
    slot falls among them are written."""
    B, n = cache_leaf.shape[:2]
    bidx = torch.arange(B, device=new.device)
    out = cache_leaf.clone()
    if lo is None:
        out[bidx, slot] = new
        return out
    local = slot - lo
    mine = (local >= 0) & (local < n)
    safe = torch.clamp(local, 0, n - 1)
    out[bidx, safe] = torch.where(
        mine.reshape((B,) + (1,) * (new.ndim - 1)), new, out[bidx, safe])
    return out


def attention_fwd(params, x, *, n_heads: int, n_kv: int, head_dim: int,
                  rope_theta: float | None, causal: bool = True,
                  window: int | None = None, positions=None,
                  tp=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). The kernel reads k/v with KV heads
    directly (head h reads kv head h // (H/KV)): no repeated copy. With
    ``tp`` splitting the heads, the rank's heads, then ``wo``'s partial
    product summed over the model group."""
    B, S, _ = x.shape
    H, h0, KV, kv0 = _local_heads(tp, n_heads, n_kv)
    split = H < n_heads
    q, k, v = _project_qkv(params, x, H, KV, head_dim, h0, kv0,
                           tp if split else None, KV < n_kv)
    if split and KV == n_kv:
        # whole k / v read by the rank's heads only
        k = _kv_for_heads(tp.enter(k), h0, H, n_heads, n_kv)
        v = _kv_for_heads(tp.enter(v), h0, H, n_heads, n_kv)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = swa_attention(q, k, v, window=window, causal=causal).to(x.dtype)
    y = out.reshape(B, S, H * head_dim) @ params["wo"].to(x.dtype)
    return tp.sum(y) if split else y


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
                     window: int | None = None, tp=None,
                     seq_shard: bool = False):
    """One-token decode. x:(B,1,D), pos:(B,) absolute position of the new
    token. Returns (y (B,1,D), new cache); the old cache is not changed.

    Cache holds ``max_len`` slots. If ``window`` is set the cache is a ring
    buffer of size max_len (== window) indexed by pos % max_len; otherwise
    the cache is positional (slot == pos). With ``tp`` the cache holds the
    rank's kv heads (or all of them), or with ``seq_shard`` its block of
    S / M slots (``max_len`` is then M times the leaf's)."""
    B = x.shape[0]
    H, h0, KV, kv0 = _local_heads(tp, n_heads, n_kv)
    if seq_shard and KV < n_kv:
        raise ValueError("a slot-split cache holds every kv head: the model "
                         "axis splits the kv heads here (cache_specs puts "
                         "them over it)")
    q, k, v = _project_qkv(params, x, H, KV, head_dim, h0, kv0)
    if rope_theta is not None:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)

    n = cache["k"].shape[1]
    lo = tp.index * n if seq_shard else None
    max_len = n * tp.size if seq_shard else n
    slot = pos % max_len if window is not None else pos
    new_k = _write_slot(cache["k"], k[:, 0], slot, lo)
    new_v = _write_slot(cache["v"], v[:, 0], slot, lo)
    # validity of each cache slot relative to the current position
    slots = torch.arange(n, device=x.device)[None, :] + (lo or 0)
    bias = torch.where(_slot_valid(slots, slot, pos, max_len, window), 0.0,
                       NEG_INF).float()[:, None, None, :]
    scale = 1.0 / head_dim ** 0.5
    if seq_shard:
        # every q head against this rank's slots, merged over the group
        qa = tp.gather(q, 2) if H < n_heads else q
        kk = _repeat_kv(new_k, n_heads)
        s = torch.einsum("bqhd,bkhd->bhqk", qa.float(), kk.float()) * scale
        s = s + bias
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bhqk,bkhd->bqhd", p,
                         _repeat_kv(new_v, n_heads).float())
        out = _lse_merge(m, p.sum(-1, keepdim=True), o, tp)
        out = out[:, :, h0:h0 + H].to(q.dtype)
    else:
        kk, vv = new_k, new_v
        if H < n_heads and KV == n_kv:
            kk = _kv_for_heads(kk, h0, H, n_heads, n_kv)
            vv = _kv_for_heads(vv, h0, H, n_heads, n_kv)
        out = sdpa(q, _repeat_kv(kk, H), _repeat_kv(vv, H), bias, scale)
    y = out.reshape(B, 1, H * head_dim) @ params["wo"].to(x.dtype)
    return (tp.sum(y) if H < n_heads else y), {"k": new_k, "v": new_v}


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


def _mla_heads(params, n_heads: int, qk_nope: int, tp) -> tuple:
    """(local heads, first head) of MLA: ``w_uk``'s columns by heads."""
    H = params["w_uk"].shape[1] // qk_nope
    return H, (tp.index * H if H < n_heads else 0)


def _mla_qkv(params, x, positions, *, n_heads, qk_nope, qk_rope, kv_rank,
             rope_theta, tp=None):
    """(q_nope, q_pe, c_kv, k_pe), q of the rank's heads. Both norms take
    rmsnorm's default eps (1e-6), as the JAX package; k_pe is roped with a
    singleton head axis. With ``tp``: ``w_dq``'s columns (the norm's
    squares summed over the group), then ``w_uq``'s rows (a sum: every
    head) or its columns (the rank's heads)."""
    B, S, _ = x.shape
    if tp is not None and tp.split("w_dq"):
        dq = tp.enter(x) @ params["w_dq"].to(x.dtype)
        cq = rmsnorm_split(params["q_norm"], dq, tp,
                           params["q_norm"]["scale"].shape[0])
    else:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"].to(x.dtype))
        if tp is not None and tp.split("w_uq", 1):
            cq = tp.enter(cq)
    qf = cq @ params["w_uq"].to(x.dtype)
    if tp is not None and tp.split("w_uq", 0):
        qf = tp.sum(qf)
    H, h0 = _mla_heads(params, n_heads, qk_nope, tp)
    q = qf.reshape(B, S, -1, qk_nope + qk_rope)
    if q.shape[2] > H:
        # every head, summed: the rank's heads enter its computation
        q = tp.enter(q)[:, :, h0:h0 + H]
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
            q_chunk: int | None = None, remat: bool = False, tp=None):
    """x (B, S, D) -> (B, S, D). Scores in fp32 (the products of the
    activation dtype summed in fp32, as ``preferred_element_type``), masked
    by −1e30, probabilities cast to the activation dtype before P·V.
    ``q_chunk``: queries in chunks of that many rows, one after another, so
    the live scores are (B, H, q_chunk, S) instead of (B, H, S, S); with
    ``remat`` and grad enabled each chunk is ``torch.utils.checkpoint``ed
    (the reference's ``jax.checkpoint`` of a chunk), so its backward keeps
    no chunk's scores but the one it recomputes. With ``tp`` splitting the
    heads, the rank's heads and ``wo``'s partial product summed."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(
        params, x, positions, n_heads=n_heads, qk_nope=qk_nope,
        qk_rope=qk_rope, kv_rank=kv_rank, rope_theta=rope_theta, tp=tp)
    H = q_nope.shape[2]
    if H < n_heads:
        # the whole latent and rope key read by the rank's heads
        c_kv, k_pe = tp.enter(c_kv), tp.enter(k_pe)
    k_nope = (c_kv @ params["w_uk"].to(x.dtype)).reshape(B, S, H, qk_nope)
    v = (c_kv @ params["w_uv"].to(x.dtype)).reshape(B, S, H, v_dim)
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
    y = out.reshape(B, S, H * v_dim) @ params["wo"].to(x.dtype)
    return tp.sum(y) if H < n_heads else y


def init_mla_cache(batch: int, max_len: int, kv_rank: int, qk_rope: int,
                   dtype, device="cpu"):
    return {"c_kv": torch.zeros((batch, max_len, kv_rank), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                                device=device)}


def mla_decode(params, cache, x, pos, *, n_heads: int, qk_nope: int,
               qk_rope: int, v_dim: int, kv_rank: int, rope_theta: float,
               window: int | None = None, tp=None, seq_shard: bool = False):
    """Absorbed-matrix MLA decode over the compressed cache: W_uk folds into
    the query and W_uv follows the latent P·V, so the cache never expands
    to per-head keys (DeepSeek-V3 §2.1). Returns (y (B,1,D), new cache);
    the old cache is not changed. Slot ``pos``, or ``pos % max_len`` with
    a window (a ring of ``max_len`` slots).

    With ``tp``: the rank's heads' absorbed queries are gathered (every
    head), then scored against the cache the rank holds: its block of the
    latent rank (partial scores summed over the group, the latent output
    gathered back) or, with ``seq_shard``, its block of slots (merged by
    log-sum-exp); the rank's heads go on through ``w_uv`` and ``wo``."""
    B = x.shape[0]
    n = cache["c_kv"].shape[1]
    q_nope, q_pe, c_kv_new, k_pe_new = _mla_qkv(
        params, x, pos[:, None], n_heads=n_heads, qk_nope=qk_nope,
        qk_rope=qk_rope, kv_rank=kv_rank, rope_theta=rope_theta, tp=tp)
    H, h0 = _mla_heads(params, n_heads, qk_nope, tp)
    R = cache["c_kv"].shape[2]                 # the latent rank held here
    r0 = tp.index * R if R < kv_rank else 0
    lo = tp.index * n if seq_shard else None
    max_len = n * tp.size if seq_shard else n

    slot = pos % max_len if window is not None else pos
    c_kv = _write_slot(cache["c_kv"], c_kv_new[:, 0, r0:r0 + R], slot, lo)
    k_pe = _write_slot(cache["k_pe"], k_pe_new[:, 0], slot, lo)

    w_uk = params["w_uk"].to(x.dtype).reshape(kv_rank, H, qk_nope)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    if (seq_shard or R < kv_rank) and H < n_heads:
        # every head's absorbed query and rope query: one gather
        qq = tp.gather(torch.cat([q_lat, q_pe], dim=3), 2)
        q_lat, q_pe = qq[..., :kv_rank], qq[..., kv_rank:]
    scale = 1.0 / (qk_nope + qk_rope) ** 0.5
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat[..., r0:r0 + R].float(),
                         c_kv.float())
    if R < kv_rank:
        s_lat = tp.sum(s_lat)
    scores = (s_lat + torch.einsum("bqhd,bkd->bhqk", q_pe.float(),
                                   k_pe.float())) * scale
    slots = torch.arange(n, device=x.device)[None, :] + (lo or 0)
    valid = _slot_valid(slots, slot, pos, max_len, window)
    scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    if seq_shard:
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        o = torch.einsum("bhqk,bkr->bqhr", p, c_kv.float())
        out_lat = _lse_merge(m, p.sum(-1, keepdim=True), o, tp).to(x.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_kv)
        if R < kv_rank:
            out_lat = tp.gather(out_lat, 3)
    if out_lat.shape[2] > H:
        out_lat = out_lat[:, :, h0:h0 + H]
    w_uv = params["w_uv"].to(x.dtype).reshape(kv_rank, H, v_dim)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)
    y = out.reshape(B, 1, H * v_dim) @ params["wo"].to(x.dtype)
    return (tp.sum(y) if H < n_heads else y), {"c_kv": c_kv, "k_pe": k_pe}
