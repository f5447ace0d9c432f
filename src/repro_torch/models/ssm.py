"""Mamba2 (SSD, state-space duality) block (``repro.models.ssm``).

Prefill uses the chunked SSD algorithm (Dao & Gu 2024, listing 1): an
intra-chunk quadratic term plus an inter-chunk state recurrence over only
seq_len/chunk steps. Steps 1-2 (the intra-chunk output Y_diag and each
chunk's end state) are the SSD kernel (``kernels.ssd_chunk``): on CUDA it
launches, on the CPU its plain version runs. Steps 3-4 (the c-step
recurrence and the state-to-output term) stay plain PyTorch, as they are
jnp in the JAX package.

The input projection is kept as separate kernels per segment
(z / x / B / C / dt), with the JAX package's keys. Decode is the O(1)
recurrent update on the carried state.

Over a model axis (``tp``) that splits d_inner (``wz`` / ``wx`` /
``conv_x``'s columns, ``out_proj``'s rows) a rank runs its block of
d_inner channels, which is its block of SSD heads: the kernel runs on the
rank's heads, ``dt_bias`` / ``A_log`` / ``D`` and the norm's scale (1-D,
replicated) are cut to them, ``wB`` / ``wC`` / ``wdt`` stay whole, the
gated norm over the whole d_inner sums its squares over the group and
``out_proj``'s partial product is summed. In training what the group holds
alike enters the rank's heads through ``ModelAxis.enter`` (x at ``wz`` /
``wx``, the B / C / dt streams, the cut 1-D params), so ``wB`` / ``wC``
/ ``wdt`` and the conv's B / C weights get whole gradients. A split that
would cut a head in two is refused (``local_heads``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
from repro_torch.models.modules import (dense_init, randn, rmsnorm,
                                        rmsnorm_split)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_mamba2(gen, d_model: int, *, d_state: int = 64, expand: int = 2,
                head_dim: int = 64, conv_width: int = 4, n_groups: int = 1,
                dtype=torch.float32, device="cpu"):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    gn = n_groups * d_state
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    u = (torch.rand((n_heads,), generator=gen, device=device)
         if torch.device(device).type != "meta"
         else torch.empty((n_heads,), device=device))
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))

    def cw(ch):
        return (randn(gen, (conv_width, ch), device)
                * (1.0 / conv_width ** 0.5)).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "wz": dense_init(gen, d_model, d_inner, dtype, device),
        "wx": dense_init(gen, d_model, d_inner, dtype, device),
        "wB": dense_init(gen, d_model, gn, dtype, device),
        "wC": dense_init(gen, d_model, gn, dtype, device),
        "wdt": dense_init(gen, d_model, n_heads, dtype, device),
        "conv_x": cw(d_inner),
        "conv_x_b": zeros(d_inner),
        "conv_B": cw(gn),
        "conv_B_b": zeros(gn),
        "conv_C": cw(gn),
        "conv_C_b": zeros(gn),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias.float(),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=device)},
        "out_proj": dense_init(gen, d_inner, d_model, dtype, device),
    }


def mamba2_dims(d_model: int, d_state: int, expand: int, head_dim: int,
                n_groups: int = 1):
    d_inner = expand * d_model
    return dict(d_inner=d_inner, n_heads=d_inner // head_dim,
                head_dim=head_dim, d_state=d_state, n_groups=n_groups)


def local_heads(d_inner: int, head_dim: int, model: int) -> int:
    """SSD heads a rank holds when the model axis (``model`` ranks) splits
    d_inner; raises when the split would cut a head in two."""
    if (d_inner // head_dim) % model:
        raise ValueError(
            f"the model axis of {model} splits d_inner = {d_inner} but not "
            f"its {d_inner // head_dim} SSD heads of {head_dim}: a head "
            "would be cut in two")
    return d_inner // head_dim // model


def _local(params, tp, di: int, H: int, P: int, n_groups: int):
    """(channels, first channel, heads, first head, the per-head and
    per-channel 1-D params cut to them) of this rank."""
    if tp is None or not tp.split("wx"):
        return di, 0, H, 0, params
    if n_groups != 1:
        raise ValueError("a split d_inner takes one B/C group (the zoo's)")
    Hl = local_heads(di, P, tp.size)
    h0, c0 = tp.index * Hl, tp.index * Hl * P
    cut = dict(params)
    for k in ("dt_bias", "A_log", "D"):
        cut[k] = tp.enter(params[k])[h0:h0 + Hl]
    cut["conv_x_b"] = tp.enter(params["conv_x_b"])[c0:c0 + Hl * P]
    return Hl * P, c0, Hl, h0, cut


def _gated_norm(params, y, z, tp, di: int):
    """The gated rmsnorm over the whole d_inner (a split: squares summed
    over the group)."""
    if y.shape[-1] == di:
        return rmsnorm(params["norm"], y * F.silu(z))
    return rmsnorm_split(params["norm"], y * F.silu(z), tp, di)


# ---------------------------------------------------------------------------
# Chunked SSD
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular segment sums (else
    −1e30)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, NEG_INF)


def ssd_chunked(X, dtA, B, C, chunk: int, init_state=None):
    """SSD over the full sequence.

    X   (b, l, h, p)   dt-scaled inputs
    dtA (b, l, h)      log decay per step (dt * A, A < 0), fp32
    B,C (b, l, g, n)   input/output projections by group, g dividing h
                       (head j reads group j // (h/g); g = h is one a head):
                       the kernels read a group in place for all its heads
                       and sum its heads' gradients themselves
    Returns (Y (b,l,h,p) fp32, final_state (b,h,p,n) fp32).
    """
    b, l, h, p = X.shape
    g, n = B.shape[-2], B.shape[-1]
    assert l % chunk == 0, (l, chunk)
    c = l // chunk
    Xc = X.reshape(b, c, chunk, h, p)
    Bc = B.reshape(b, c, chunk, g, n)
    Cc = C.reshape(b, c, chunk, g, n)
    A = dtA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)         # (b,h,c,Q)
    A_cs = torch.cumsum(A, dim=-1)                              # (b,h,c,Q)

    # 1-2) intra-chunk output and chunk-end states: the SSD kernel
    Y_diag, states = ssd_intra_chunk(Xc, A_cs, Bc, Cc)

    # 3) inter-chunk recurrence (the only sequential part: c steps)
    chunk_decay = torch.exp(A_cs[..., -1])                      # (b,h,c)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
             if init_state is None else init_state.float())
    prev = []
    for j in range(c):
        prev.append(carry)                     # state *entering* chunk j
        carry = chunk_decay[:, :, j, None, None] * carry + states[:, j]
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)

    # 4) state -> output within each chunk: one product per (b, c, group)
    # over n, the group's heads r side by side, so C's gradient comes out
    # by group (no per-head copy of C or of its gradient)
    r = h // g
    state_decay_out = torch.exp(A_cs)                           # (b,h,c,Q)
    Y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc.float(),
                         prev_states.reshape(b, c, g, r, p, n))
    Y_off = (Y_off.reshape(b, c, chunk, h, p)
             * state_decay_out.permute(0, 2, 3, 1)[..., None])
    return (Y_diag + Y_off).reshape(b, l, h, p), carry


# ---------------------------------------------------------------------------
# Full block forward (training / prefill)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b):
    """Depthwise causal conv. x:(B,S,C), w:(W,C)."""
    W, S = w.shape[0], x.shape[1]
    out = None
    for i in range(W):
        # x shifted right by W-1-i steps: pads[i][t] = x[t - (W-1-i)]
        shifted = F.pad(x, (0, 0, W - 1 - i, i))[:, :S]
        term = shifted * w[i][None, None, :]
        out = term if out is None else out + term
    return out + b[None, None, :]


def mamba2_fwd(params, x, *, d_state: int, expand: int, head_dim: int,
               chunk: int = 128, n_groups: int = 1, tp=None):
    B_, S, D = x.shape
    dims = mamba2_dims(D, d_state, expand, head_dim, n_groups)
    di_all, P, N = dims["d_inner"], head_dim, d_state
    di, _, H, h0, params = _local(params, tp, di_all, dims["n_heads"], P,
                                     n_groups)

    dt_ = x.dtype
    # a split d_inner: x enters the rank's channels, and the whole B / C /
    # dt streams its heads (the SSD kernels' dB / dC are the rank's heads'
    # sums: the group's sum completes them)
    ent = (lambda t: t) if di == di_all else tp.enter
    xl = ent(x)
    z = xl @ params["wz"].to(dt_)
    xs = F.silu(_causal_conv(xl @ params["wx"].to(dt_),
                             params["conv_x"].to(dt_),
                             params["conv_x_b"].to(dt_)))
    Bm = ent(F.silu(_causal_conv(x @ params["wB"].to(dt_),
                                 params["conv_B"].to(dt_),
                                 params["conv_B_b"].to(dt_))))
    Cm = ent(F.silu(_causal_conv(x @ params["wC"].to(dt_),
                                 params["conv_C"].to(dt_),
                                 params["conv_C_b"].to(dt_))))
    dt_raw = ent(x @ params["wdt"].to(dt_))[..., h0:h0 + H]

    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])  # (B,S,H)
    A = -torch.exp(params["A_log"])                                     # (H,)
    dtA = dt * A[None, None, :]                                         # log decay

    X = xs.reshape(B_, S, H, P) * dt[..., None].to(dt_)
    # B and C stay by group: the kernels expand them over the heads
    Y, _ = ssd_chunked(X, dtA, Bm.reshape(B_, S, n_groups, N),
                       Cm.reshape(B_, S, n_groups, N), chunk)
    Y = Y.to(dt_) + params["D"].to(dt_)[None, None, :, None] * xs.reshape(
        B_, S, H, P)
    y = _gated_norm(params, Y.reshape(B_, S, di), z, tp, di_all)
    y = y @ params["out_proj"].to(dt_)
    return tp.sum(y) if di < di_all else y


# ---------------------------------------------------------------------------
# Decode (single token, O(1) state)
# ---------------------------------------------------------------------------

def init_mamba2_cache(batch: int, d_model: int, *, d_state: int, expand: int,
                      head_dim: int, conv_width: int = 4, n_groups: int = 1,
                      dtype=torch.float32, device="cpu"):
    dims = mamba2_dims(d_model, d_state, expand, head_dim, n_groups)
    gn = n_groups * d_state

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": z(batch, conv_width - 1, dims["d_inner"]),
        "conv_B": z(batch, conv_width - 1, gn),
        "conv_C": z(batch, conv_width - 1, gn),
        "ssm": z(batch, dims["n_heads"], head_dim, d_state),
    }


def _conv_step(state, new, w, b):
    """state: (B, W-1, C); new: (B, C) -> (out (B, C), new state)."""
    window = torch.cat([state, new[:, None, :]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:]


def mamba2_step(params, cache, x, *, d_state: int, expand: int,
                head_dim: int, n_groups: int = 1, tp=None):
    """x: (B, 1, D) -> (y (B,1,D), new cache). With ``tp`` splitting
    d_inner the cache holds the rank's ``conv_x`` channels and ``ssm``
    heads."""
    B_, _, D = x.shape
    dims = mamba2_dims(D, d_state, expand, head_dim, n_groups)
    di_all, P, N = dims["d_inner"], head_dim, d_state
    di, _, H, h0, params = _local(params, tp, di_all, dims["n_heads"], P,
                                     n_groups)
    dt_ = x.dtype
    xt = x[:, 0]

    z = xt @ params["wz"].to(dt_)
    xs_raw, cx = _conv_step(cache["conv_x"], xt @ params["wx"].to(dt_),
                            params["conv_x"].to(dt_),
                            params["conv_x_b"].to(dt_))
    Bm_raw, cB = _conv_step(cache["conv_B"], xt @ params["wB"].to(dt_),
                            params["conv_B"].to(dt_),
                            params["conv_B_b"].to(dt_))
    Cm_raw, cC = _conv_step(cache["conv_C"], xt @ params["wC"].to(dt_),
                            params["conv_C"].to(dt_),
                            params["conv_C_b"].to(dt_))
    xs, Bm, Cm = map(F.silu, (xs_raw, Bm_raw, Cm_raw))
    dt_raw = (xt @ params["wdt"].to(dt_))[:, h0:h0 + H]

    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :]).to(dt_)                   # (B,H)

    rep = H // n_groups
    Bh = torch.repeat_interleave(Bm.reshape(B_, n_groups, N), rep, dim=1)
    Ch = torch.repeat_interleave(Cm.reshape(B_, n_groups, N), rep, dim=1)
    Xh = xs.reshape(B_, H, P) * dt[..., None].to(dt_)

    new_ssm = (decay[..., None, None] * cache["ssm"]
               + torch.einsum("bhp,bhn->bhpn", Xh, Bh))
    Yh = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    Yh = Yh + params["D"].to(dt_)[None, :, None] * xs.reshape(B_, H, P)
    y = _gated_norm(params, Yh.reshape(B_, di), z, tp, di_all)
    y = (y @ params["out_proj"].to(dt_))[:, None, :]
    if di < di_all:
        y = tp.sum(y)
    return y, {"conv_x": cx, "conv_B": cB, "conv_C": cC, "ssm": new_ssm}
