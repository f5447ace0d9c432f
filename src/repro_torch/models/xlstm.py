"""xLSTM blocks (``repro.models.xlstm``): sLSTM (scalar memory, recurrent
gating) and mLSTM (matrix memory), Beck et al. 2024 (arXiv:2405.04517),
stabilized formulations.

Both recurrent scans are a plain loop over time (on ``meta``, the dry
run's tensors, one folded step: ``_folded``). The JAX package's
``jax.checkpoint`` chunks of ``chunk`` steps bound only the memory of a
backward pass and change no value: here they are
``torch.utils.checkpoint``ed chunks when ``remat`` is set and grad is
enabled (the zoo passes ``cfg.remat``), and ``chunk`` picks nothing else.
The chunkwise-parallel mLSTM (``mlstm_chunkwise``) is the reference's
SSD-like form: an intra-chunk masked (Q × Q) product
and a loop over chunks carrying the stabilized (C, n, m) state. The JAX
package runs both in jnp, outside any kernel, and so does the port.

Gate arithmetic is fp32 whatever the activation dtype; products of the
activation dtype that the reference accumulates in fp32
(``preferred_element_type``) are computed here on fp32 copies, which
holds each product exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.modules import (dense_init, init_layernorm,
                                        layernorm, randn)

M_INIT = -30.0          # the stabilizer's start: a large negative, not −inf


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def _zeros32(*shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ===========================================================================
# sLSTM
# ===========================================================================

def init_slstm(gen, d_model: int, n_heads: int, dtype=torch.float32,
               device="cpu"):
    dh = d_model // n_heads
    d_ff = (4 * d_model) // 3
    return {
        "ln": init_layernorm(d_model, dtype, device),
        # the gates' input projection, i, f, z, o; the block-diagonal
        # recurrent weights, one (dh, 4·dh) block a head
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype, device),
        "r": (randn(gen, (n_heads, dh, 4 * dh), device)
              * (1.0 / dh ** 0.5)).to(dtype),
        "b": torch.zeros((4 * d_model,), dtype=dtype, device=device),
        "gn": init_layernorm(d_model, dtype, device),     # post group-norm
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def slstm_cell(params, carry, x_t, n_heads: int):
    """One step. carry = (h, c, n, m), each (B, d): h in x's dtype, the
    rest fp32. x_t: (B, d). The recurrent term is added per head, and the
    gates split over the flat 4·d (not per head), as the JAX package."""
    h, c, n, m = carry
    B, d = x_t.shape
    dh = d // n_heads
    gates_in = x_t @ params["w_in"].to(x_t.dtype)                  # (B, 4d)
    gates_rec = torch.einsum("bhd,hde->bhe", h.reshape(B, n_heads, dh),
                             params["r"].to(x_t.dtype))
    gates = ((gates_in.reshape(B, n_heads, 4 * dh) + gates_rec)
             .reshape(B, 4 * d) + params["b"].to(x_t.dtype))
    i_r, f_r, z_r, o_r = torch.chunk(gates.float(), 4, dim=-1)

    f_log = _logsigmoid(f_r)
    m_new = torch.maximum(f_log + m, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(f_log + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_r)
    n_new = f_g * n + i_g
    h_new = (torch.sigmoid(o_r) * c_new
             / torch.clamp(n_new, min=1e-6)).to(x_t.dtype)
    return (h_new, c_new, n_new, m_new), h_new


def _slstm_init(B: int, d: int, dtype, device):
    return (torch.zeros((B, d), dtype=dtype, device=device),
            _zeros32(B, d, device=device), _zeros32(B, d, device=device),
            _zeros32(B, d, device=device) + M_INIT)


def _time_loop(cell, carry: tuple, xs: tuple, chunk: int, remat: bool):
    """carry, h_t = cell(carry, *(x[:, t] for x in xs)) for t < S (xs:
    (B, S, ...) inputs) -> (final carry, the h_t stacked on dim 1). With
    ``remat`` and grad enabled, each run of q steps (q = ``chunk`` cut to
    divide S, as the reference cuts it) goes under
    ``torch.utils.checkpoint``: the reference's ``jax.checkpoint`` around
    each chunk's scan. The values do not change. On ``meta`` the loop is
    ``_folded``."""
    S = xs[0].shape[1]
    if xs[0].is_meta and S > 1:
        return _folded(cell, carry, xs, remat)

    def run(t0: int, q: int, *carry):
        hs = []
        for t in range(t0, t0 + q):
            carry, h = cell(carry, *(x[:, t] for x in xs))
            hs.append(h)
        return (*carry, torch.stack(hs, dim=1))

    if not (remat and torch.is_grad_enabled()):
        *carry, h = run(0, S, *carry)
        return tuple(carry), h
    q = min(chunk, S)
    while S % q:
        q -= 1
    chunks = []
    for t0 in range(0, S, q):
        *carry, h = checkpoint(run, t0, q, *carry, use_reentrant=False)
        chunks.append(h)
    return tuple(carry), torch.cat(chunks, dim=1)


def _folded(cell, carry: tuple, xs: tuple, remat: bool):
    """``_time_loop`` on ``meta`` (shapes only: the dry run). No value flows
    from step to step, so steps 1 … S−1 run as one step over B·(S − 1)
    rows from step 1's carry, expanded: the loop's ops on the same shapes,
    so the same FLOPs forward and backward (``FlopCounterMode``: each
    counted op's FLOPs grow with its rows), without S − 1 Python steps.
    Step 0 runs alone: its carry needs no gradient, the later ones do.
    With ``remat`` the whole scan is one checkpoint: recomputed once, as
    the loop's chunks are."""
    B, S = xs[0].shape[:2]

    def rows(a):
        return a[:, None].expand(B, S - 1, *a.shape[1:]).reshape(
            B * (S - 1), *a.shape[1:])

    def run(*carry):
        carry, h0 = cell(carry, *(x[:, 0] for x in xs))
        carry, h = cell(tuple(rows(a) for a in carry),
                        *(x[:, 1:].reshape(B * (S - 1), *x.shape[2:])
                          for x in xs))
        last = tuple(a.reshape(B, S - 1, *a.shape[1:])[:, -1] for a in carry)
        return (*last, torch.cat([h0[:, None],
                                  h.reshape(B, S - 1, *h.shape[1:])], dim=1))

    if remat and torch.is_grad_enabled():
        *carry, h = checkpoint(run, *carry, use_reentrant=False)
    else:
        *carry, h = run(*carry)
    return tuple(carry), h


def slstm_scan(params, x, n_heads: int, chunk: int = 64, init=None,
               remat: bool = False):
    """x: (B, S, d) -> (h_seq (B, S, d), final carry)."""
    B, S, d = x.shape
    carry = _slstm_init(B, d, x.dtype, x.device) if init is None else init
    carry, h = _time_loop(
        lambda c, x_t: slstm_cell(params, c, x_t, n_heads), tuple(carry),
        (x,), chunk, remat)
    return h, carry


def _slstm_ffn(params, x):
    """The block's gated post-FFN (factor 4/3)."""
    g = F.silu(x @ params["w_gate"].to(x.dtype))
    up = x @ params["w_up"].to(x.dtype)
    return x + (g * up) @ params["w_down"].to(x.dtype)


def slstm_block_fwd(params, x, *, n_heads: int, chunk: int = 64,
                    remat: bool = False):
    """Full pre-norm sLSTM block with the post-FFN."""
    h, _ = slstm_scan(params, layernorm(params["ln"], x), n_heads, chunk,
                      remat=remat)
    return _slstm_ffn(params, x + layernorm(params["gn"], h))


def init_slstm_cache(batch: int, d_model: int, dtype=torch.float32,
                     device="cpu"):
    h, c, n, m = _slstm_init(batch, d_model, dtype, device)
    return {"h": h, "c": c, "n": n, "m": m}


def slstm_block_step(params, cache, x, *, n_heads: int):
    """x: (B, 1, d) decode step -> (y (B, 1, d), new cache)."""
    xt = layernorm(params["ln"], x)[:, 0]
    carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    carry, h = slstm_cell(params, carry, xt, n_heads)
    y = _slstm_ffn(params, x + layernorm(params["gn"], h)[:, None, :])
    return y, dict(zip(("h", "c", "n", "m"), carry))


# ===========================================================================
# mLSTM
# ===========================================================================

def init_mlstm(gen, d_model: int, n_heads: int, *, proj_factor: int = 2,
               dtype=torch.float32, device="cpu"):
    """The gate projection ``w_if`` and bias ``b_if`` are fp32 whatever
    ``dtype``; the forget-gate bias runs 3 to 6 over the heads."""
    di = proj_factor * d_model
    return {
        "ln": init_layernorm(d_model, dtype, device),
        "w_up": dense_init(gen, d_model, di, dtype, device),
        "w_gate_out": dense_init(gen, d_model, di, dtype, device),
        "wq": dense_init(gen, di, di, dtype, device),
        "wk": dense_init(gen, di, di, dtype, device),
        "wv": dense_init(gen, di, di, dtype, device),
        "w_if": dense_init(gen, di, 2 * n_heads, torch.float32, device,
                           scale=0.02),
        "b_if": torch.cat([_zeros32(n_heads, device=device),
                           torch.linspace(3.0, 6.0, n_heads, device=device)]),
        "gn": init_layernorm(di, dtype, device),
        "w_down": dense_init(gen, di, d_model, dtype, device),
    }


def mlstm_cell(carry, inp):
    """carry: (C (B,H,P,P), n (B,H,P), m (B,H)), fp32; inp: q, k, v
    (B,H,P), raw i/f gate logits (B,H). k is scaled by 1/√P in fp32."""
    C, n, m = carry
    q, k, v, i_r, f_r = inp
    P = q.shape[-1]
    f_log = _logsigmoid(f_r)
    m_new = torch.maximum(f_log + m, i_r)                            # (B,H)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(f_log + m - m_new)
    k32 = k.float() / P ** 0.5
    v32 = v.float()
    C_new = (f_g[..., None, None] * C
             + i_g[..., None, None] * (k32[..., :, None] * v32[..., None, :]))
    n_new = f_g[..., None] * n + i_g[..., None] * k32
    q32 = q.float()
    num = torch.einsum("bhp,bhpv->bhv", q32, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", q32, n_new)),
                        torch.exp(-m_new)) + 1e-6
    h = (num / den[..., None]).to(q.dtype)
    return (C_new, n_new, m_new), h


def _mlstm_init(B: int, H: int, P: int, device):
    return (_zeros32(B, H, P, P, device=device), _zeros32(B, H, P,
                                                          device=device),
            _zeros32(B, H, device=device) + M_INIT)


def _mlstm_qkv_if(x_inner, params, n_heads: int):
    """q, k, v (B, S, H, P) in x's dtype; raw i, f gate logits (B, S, H) in
    fp32 (``x.float() @ w_if + b_if``)."""
    B, S, di = x_inner.shape
    P = di // n_heads
    dt = x_inner.dtype
    q, k, v = ((x_inner @ params[w].to(dt)).reshape(B, S, n_heads, P)
               for w in ("wq", "wk", "wv"))
    if_r = (x_inner.float() @ params["w_if"].float()
            + params["b_if"].float()).reshape(B, S, 2, n_heads)
    return q, k, v, if_r[:, :, 0], if_r[:, :, 1]


def mlstm_scan(x_inner, params, n_heads: int, chunk: int = 32, init=None,
               remat: bool = False):
    """Recurrent mLSTM. x_inner: (B, S, di) pre-projected. Returns
    (h (B, S, di), carry)."""
    B, S, di = x_inner.shape
    q, k, v, i_r, f_r = _mlstm_qkv_if(x_inner, params, n_heads)
    carry = (_mlstm_init(B, n_heads, di // n_heads, x_inner.device)
             if init is None else init)
    carry, h = _time_loop(lambda c, *inp: mlstm_cell(c, inp), tuple(carry),
                          (q, k, v, i_r, f_r), chunk, remat)
    return h.reshape(B, S, di), carry


def k_scale(P: int, dtype) -> float:
    """The chunkwise form's scale of k: 1/√P rounded to k's dtype (bf16 at
    P = 512: 0.0441895, not 0.0441942), as the JAX package multiplies by
    ``jnp.asarray(scale, k.dtype)``."""
    return torch.tensor(1.0 / P ** 0.5, dtype=dtype).item()


def mlstm_chunkwise(q, k, v, i_r, f_r, chunk: int, init=None):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, S, H, P); i_r, f_r: raw gate logits (B, S, H). Returns
    (h (B, S, H, P) in q's dtype, carry). S must be a multiple of
    ``chunk`` (no padding). k's scale is rounded to k's dtype first
    (``k_scale``), and the intra-chunk weights to v's dtype before the P·V
    product, as the JAX package rounds them."""
    B, S, H, P = q.shape
    Q = chunk
    if S % Q:
        raise ValueError(f"mlstm_chunkwise: S={S} is not a multiple of the "
                         f"chunk {Q}")
    NC = S // Q
    scale = k_scale(P, k.dtype)
    f_log = _logsigmoid(f_r.float())

    def resh(a):
        return a.reshape(B, NC, Q, *a.shape[2:])
    qc, kc, vc = resh(q), resh(k * scale), resh(v)
    ic = resh(i_r.float())                                   # (B,NC,Q,H)
    b = torch.cumsum(resh(f_log), dim=2)           # inclusive log-decay sums

    # intra-chunk log weights D[t, j] = b_t − b_j + i_j (j <= t)
    D = b[:, :, :, None, :] - b[:, :, None, :, :] + ic[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    D = torch.where(tri[None, None, :, :, None], D, -1e30)   # (B,NC,Q,Q,H)
    m_intra = D.amax(dim=3)                                  # (B,NC,Q,H)

    C_p, n_p, m_p = _mlstm_init(B, H, P, q.device) if init is None else init
    hs = []
    for c in range(NC):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]            # (B,Q,H,P)
        bb, ii, DD, mi = b[:, c], ic[:, c], D[:, c], m_intra[:, c]
        q32, k32, v32 = qq.float(), kk.float(), vv.float()
        m_state = bb + m_p[:, None, :]                       # (B,Q,H)
        m_t = torch.maximum(mi, m_state)
        s = torch.einsum("bqhp,bjhp->bqjh", q32, k32)
        w = torch.exp(DD - m_t[:, :, None, :]) * s           # (B,Q,Q,H)
        num = torch.einsum("bqjh,bjhp->bqhp", w.to(vv.dtype).float(), v32)
        den = torch.sum(w, dim=2)                            # q·n_intra
        sc_state = torch.exp(m_state - m_t)
        num = num + sc_state[..., None] * torch.einsum("bqhp,bhpv->bqhv",
                                                       q32, C_p)
        den = den + sc_state * torch.einsum("bqhp,bhp->bqh", q32, n_p)
        hs.append(num / (torch.maximum(torch.abs(den),
                                       torch.exp(-m_t))[..., None] + 1e-6))

        # the carry into the next chunk
        g = bb[:, -1:, :] - bb + ii                          # (B,Q,H)
        m_C = torch.maximum(bb[:, -1] + m_p, g.amax(dim=1))  # (B,H)
        sc_prev = torch.exp(bb[:, -1] + m_p - m_C)
        wg = torch.exp(g - m_C[:, None, :]).to(kk.dtype).float()
        C_p = sc_prev[..., None, None] * C_p + torch.einsum(
            "bqh,bqhp,bqhv->bhpv", wg, k32, v32)
        n_p = sc_prev[..., None] * n_p + torch.einsum("bqh,bqhp->bhp", wg,
                                                      k32)
        m_p = m_C
    h = torch.stack(hs, dim=1).reshape(B, S, H, P)
    return h.to(q.dtype), (C_p, n_p, m_p)


def mlstm_seq(x_inner, params, n_heads: int, chunk: int = 32,
              impl: str = "recurrent", remat: bool = False):
    """Dispatch: the recurrent scan (``remat``: checkpointed chunks), or the
    chunkwise-parallel form (chunk ``min(chunk, S)``, which must divide
    S)."""
    if impl == "recurrent":
        return mlstm_scan(x_inner, params, n_heads, chunk, remat=remat)
    if impl != "chunkwise":
        raise ValueError(f"mlstm_impl {impl!r}: recurrent or chunkwise")
    B, S, di = x_inner.shape
    q, k, v, i_r, f_r = _mlstm_qkv_if(x_inner, params, n_heads)
    h, carry = mlstm_chunkwise(q, k, v, i_r, f_r, min(chunk, S))
    return h.reshape(B, S, di), carry


def _mlstm_in(params, x):
    """(inner, output gate) of the block's pre-norm input."""
    xn = layernorm(params["ln"], x)
    return (xn @ params["w_up"].to(x.dtype),
            F.silu(xn @ params["w_gate_out"].to(x.dtype)))


def mlstm_block_fwd(params, x, *, n_heads: int, proj_factor: int = 2,
                    chunk: int = 32, impl: str = "recurrent",
                    remat: bool = False):
    inner, gate = _mlstm_in(params, x)
    h, _ = mlstm_seq(inner, params, n_heads, chunk, impl=impl, remat=remat)
    h = layernorm(params["gn"], h) * gate
    return x + h @ params["w_down"].to(x.dtype)


def init_mlstm_cache(batch: int, d_model: int, n_heads: int,
                     proj_factor: int = 2, dtype=torch.float32,
                     device="cpu"):
    """fp32 states whatever ``dtype`` (kept for the JAX signature)."""
    C, n, m = _mlstm_init(batch, n_heads, proj_factor * d_model // n_heads,
                          device)
    return {"C": C, "n": n, "m": m}


def mlstm_block_step(params, cache, x, *, n_heads: int,
                     proj_factor: int = 2):
    """x: (B, 1, d) decode step -> (y (B, 1, d), new cache)."""
    B, _, d = x.shape
    di = proj_factor * d
    inner, gate = _mlstm_in(params, x)
    q, k, v, i_r, f_r = _mlstm_qkv_if(inner, params, n_heads)
    carry = (cache["C"], cache["n"], cache["m"])
    carry, h = mlstm_cell(carry, (q[:, 0], k[:, 0], v[:, 0], i_r[:, 0],
                                  f_r[:, 0]))
    h = layernorm(params["gn"], h.reshape(B, 1, di)) * gate
    return x + h @ params["w_down"].to(x.dtype), dict(zip(("C", "n", "m"),
                                                         carry))
