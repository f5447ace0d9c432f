"""What ``ssd_intra_chunk`` decides in Python, on the CPU: which route it
takes and which strides its tensor-core route's TMA loads accept; and — by
a torch emulation of ``csrc/ssd_chunk_tc.cu``'s arithmetic — that the
route's design meets the fp32 route's 2e-4, and why it splits its fp32
operands into three bf16 terms and not two.

The emulation repeats the kernel step by step: bf16 X, B, C; G = C·Bᵀ in
fp32 over the causal triangle's tiles only (rows 0-63 against columns
0-63, rows 64-127 against columns 0-127); S = G ⊙ L with L a select on
j <= i of exp2((a_i − a_j)·log2 e); S, and B ⊙ w with w_k = exp2((a_last −
a_k)·log2 e), split into bf16 terms hi, mid, lo, each the truncation to
bf16 of what is left; fp32 accumulation in the kernel's order (16-column
k-steps, each k-step's terms in turn). Inputs
are made from a seed with numpy at Zamba2's widths (Q = 128, P = N = 64),
4 heads and 2 chunks, with B/C one group expanded over the heads with
stride 0 (the model's layout) or one per head, in two decay regimes:
dtA = −softplus(randn) (fast: L falls off within a few steps) and dtA =
−0.01·softplus(randn) (slow: L ~ 1 across the chunk, so all 128 products of
a row count; the worst case for rounding).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro_torch.configs import registry
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as ssd_mod

SSD_TOL = 2e-4          # the fp32 route's tolerance, which the tc route keeps
LOG2E = math.log2(math.e)
TERMS = 3               # ssd_chunk_tc.cu's kTerms
DECAY = {"fast": 1.0, "slow": 0.01}


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def test_zamba2_prefill_takes_the_tensor_core_route():
    cfg = registry.get("zamba2-1.2b")
    assert cfg.dtype == "bfloat16"
    dt = getattr(torch, cfg.dtype)
    assert ssd_mod._route(dt, dt, cfg.ssd_chunk, cfg.ssm_head_dim,
                          cfg.ssm_state) == "tc"


bf, f32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dx,dbc,Q,P,N,route", [
    (bf, bf, 128, 64, 64, "tc"),          # Zamba2 prefill
    (bf, bf, 64, 64, 64, "tc"),
    (f32, f32, 128, 64, 64, "fp32"),      # Zamba2's fp32 forward
    (bf, f32, 128, 64, 64, "fp32"),       # mixed dtypes
    (f32, bf, 128, 64, 64, "fp32"),
    (torch.float16, torch.float16, 128, 64, 64, "fp32"),
    (bf, bf, 37, 64, 64, "fp32"),         # ragged Q (the Pallas layout)
    (bf, bf, 96, 64, 64, "fp32"),
    (bf, bf, 16, 64, 64, "fp32"),
    (bf, bf, 128, 23, 64, "fp32"),        # ragged P
    (bf, bf, 128, 32, 64, "fp32"),
    (bf, bf, 128, 64, 11, "fp32"),        # ragged N
    (bf, bf, 128, 64, 128, "fp32"),
])
def test_route_depends_on_dtype_and_shape_only(dx, dbc, Q, P, N, route):
    assert ssd_mod._route(dx, dbc, Q, P, N) == route


def _model_layout(b=2, c=3, Q=128, h=4, p=64, n=64, dtype=bf):
    X = torch.zeros((b, c * Q, h, p), dtype=dtype).reshape(b, c, Q, h, p)
    Bg = torch.zeros((b, c * Q, 1, n), dtype=dtype)
    Bc = Bg.expand(b, c * Q, h, n).reshape(b, c, Q, h, n)
    A_cs = torch.zeros((b, h, c, Q))
    return X, A_cs, Bc


def test_tma_strides_read_the_models_layout_in_place():
    X, A_cs, Bc = _model_layout()
    assert ssd_mod._tma_strides("X", X, 4) == (3 * 128 * 4 * 64,
                                               128 * 4 * 64, 4 * 64, 64)
    assert ssd_mod._tma_strides("A_cs", A_cs, 3) == (4 * 3 * 128, 3 * 128,
                                                     128)
    # one B/C group expanded with stride 0: the map reads one head
    assert Bc.stride(3) == 0
    assert ssd_mod._tma_strides("B", Bc, 4, broadcast=3) == (
        3 * 128 * 64, 128 * 64, 64, 64)
    assert ssd_mod._per_head(Bc) == 0
    assert ssd_mod._per_head(Bc.contiguous()) == 1
    # the Pallas layout: a size-1 head dim is never stepped
    cells = torch.zeros((6, 2, 128, 64), dtype=bf)[:, :, :, None]
    assert ssd_mod._tma_strides("X", cells, 4) == (2 * 128 * 64, 128 * 64,
                                                   64, 64)
    assert ssd_mod._per_head(cells) == 0


def test_tma_rules_are_checked_on_the_strides():
    X, A_cs, Bc = _model_layout()
    odd = torch.zeros((2, 3 * 128, 4, 68), dtype=bf)[..., :64].reshape(
        2, 3, 128, 4, 64)                         # rows 136 bytes apart
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_mod._tma_strides("X", odd, 4)
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_mod._tma_strides("B", Bc, 4)          # stride 0 only as broadcast
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod._tma_strides("A_cs", A_cs.transpose(-1, -2).contiguous()
                             .transpose(-1, -2), 3)
    flat = torch.zeros(1 + X.numel(), dtype=bf)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_mod._tma_strides("X", flat[1:].view(X.shape), 4)


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic, emulated
# ---------------------------------------------------------------------------

def trunc_bf16(x: torch.Tensor) -> torch.Tensor:
    """x with the low 16 bits of its fp32 pattern cleared (bf16, truncated),
    as ``ssd_chunk_tc.cu``'s ``trunc16``."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def split_bf16(x: torch.Tensor, terms: int) -> list:
    """Terms exact in bf16, each the truncation of what is left; every
    residual is exact in fp32, and three terms sum to x exactly."""
    out, r = [], x
    for _ in range(terms):
        t = trunc_bf16(r)
        out.append(t)
        r = r - t
    return out


def tc_emulation(Xc, A_cs, Bc, Cc, terms: int = TERMS):
    """``ssd_chunk_tc.cu``'s arithmetic in torch, in the model's layout:
    Xc (b, c, Q, h, 64), Bc, Cc (b, c, Q, h, 64) bf16; A_cs (b, h, c, Q)
    fp32 -> (Y_diag (b, c, Q, h, 64), states (b, c, h, 64, 64)) fp32."""
    b, c, Q, h, p = Xc.shape
    X, B, C = (t.float().permute(0, 1, 3, 2, 4) for t in (Xc, Bc, Cc))
    a = A_cs.permute(0, 2, 1, 3)                         # (b, c, h, Q)
    idx = torch.arange(Q)
    Y = torch.zeros((b, c, h, Q, p))
    for r0 in range(0, Q, 64):                           # a consumer's rows
        rows, ncol = slice(r0, r0 + 64), r0 + 64         # triangle tiles
        G = C[..., rows, :] @ B[..., :ncol, :].transpose(-1, -2)
        keep = idx[None, :ncol] <= idx[rows, None]
        d = a[..., rows, None] - a[..., None, :ncol]
        S = torch.where(keep, G * torch.exp2(d * LOG2E), 0.0)
        for k0 in range(0, ncol, 16):
            for t in split_bf16(S[..., k0:k0 + 16], terms):
                Y[..., rows, :] += t @ X[..., k0:k0 + 16, :]
    w = torch.exp2((a[..., -1:] - a) * LOG2E)
    Bw = B * w[..., None]
    St = torch.zeros((b, c, h, B.shape[-1], p))          # stateᵀ (n, p)
    for k0 in range(0, Q, 16):
        for t in split_bf16(Bw[..., k0:k0 + 16, :], terms):
            St += t.transpose(-1, -2) @ X[..., k0:k0 + 16, :]
    return Y.permute(0, 1, 3, 2, 4), St.transpose(-1, -2)


def _inputs(seed, decay, per_head, b=1, c=2, Q=128, h=4, p=64, n=64):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               ).to(torch.bfloat16)
    X = bf16(b, c, Q, h, p)
    if per_head:
        Bc, Cc = bf16(b, c, Q, h, n), bf16(b, c, Q, h, n)
    else:
        Bc, Cc = (bf16(b, c, Q, 1, n).expand(b, c, Q, h, n)
                  for _ in range(2))
    raw = rng.normal(size=(b, h, c, Q)).astype(np.float32)
    dtA = -DECAY[decay] * np.log1p(np.exp(raw))          # −s·softplus
    return X, torch.cumsum(torch.as_tensor(dtA), -1), Bc, Cc


def _max_excess(got, want, tol=SSD_TOL):
    """max of |got − want| − tol·(1 + |want|): <= 0 where allclose holds."""
    return float(((got - want).abs() - tol * (1 + want.abs())).max())


CASES = [(d, ph) for d in ("fast", "slow") for ph in (False, True)]


@pytest.mark.parametrize("decay,per_head", CASES)
def test_tc_emulation_meets_the_fp32_tolerance(decay, per_head):
    args = _inputs(3, decay, per_head)
    Y, S = tc_emulation(*args)
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    assert torch.isfinite(Y).all() and torch.isfinite(S).all()
    torch.testing.assert_close(Y, Yr, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("decay,per_head", CASES)
def test_tc_emulation_matches_the_pallas_kernel(decay, per_head):
    """Against the Pallas kernel in interpret mode, in its (BH, NC, Q, ·)
    layout, fed the same bf16 values as fp32."""
    X, A_cs, Bc, Cc = _inputs(5, decay, per_head)
    b, c, Q, h, p = X.shape

    def cells(t):                                        # (b·h, c, Q, ·)
        return jnp.asarray(t.float().permute(0, 3, 1, 2, 4).reshape(
            b * h, c, Q, -1).numpy())
    Yj, Sj = jops.ssd_chunk_block(cells(X), jnp.asarray(
        A_cs.reshape(b * h, c, Q).numpy()), cells(Bc), cells(Cc))
    Y, S = tc_emulation(X, A_cs, Bc, Cc)
    Yp = torch.as_tensor(np.array(Yj)).reshape(b, h, c, Q, p).permute(
        0, 2, 3, 1, 4)
    Sp = torch.as_tensor(np.array(Sj)).reshape(b, h, c, -1, p).permute(
        0, 2, 1, 4, 3)                                   # (N, P) -> (P, N)
    torch.testing.assert_close(Y, Yp, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sp, atol=SSD_TOL, rtol=SSD_TOL)


def test_three_bf16_terms_are_exact():
    x = torch.as_tensor(np.random.default_rng(1).normal(
        scale=10.0, size=4096).astype(np.float32))
    hi, mid, lo = split_bf16(x, 3)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert torch.equal((hi + mid) + lo, x)


def test_tc_emulation_at_q64():
    args = _inputs(9, "slow", False, Q=64, c=3)
    Y, S = tc_emulation(*args)
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    torch.testing.assert_close(Y, Yr, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("per_head", [False, True])
def test_three_terms_are_needed_where_decay_is_slow(per_head):
    """Why ``kTerms`` is 3: with two bf16 terms S keeps 16 bits, and where
    L ~ 1 over the chunk the error of 128 products per row passes 2e-4; one
    term (S cut to bf16, as the SWA route rounds P) is far off. Three terms
    are exact."""
    args = _inputs(3, "slow", per_head)
    Yr, _ = ref.ssd_intra_chunk_ref(*args)
    excess = {t: _max_excess(tc_emulation(*args, terms=t)[0], Yr)
              for t in (1, 2, 3)}
    assert excess[1] > 0.1, excess
    assert excess[2] > 0, excess
    assert excess[3] < 0, excess
