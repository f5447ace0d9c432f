"""What the card's kernels decide in Python, on the CPU: which route
``swa_attention`` takes, how the ``madc`` kernel's 1-D grid covers the
upper triangle, and — by a torch emulation of its arithmetic — that the
tensor-core route's design fits its 1e-2 tolerance.

The emulation repeats ``csrc/swa_attention_tc.cu`` step by step: 128-row
query tiles against the 128-key tiles the kernel visits, fp32 scores of
the bf16 inputs, −1e30 masking, an online softmax in base 2 with the
running max in score units, P rounded to bf16 before P·V and the
denominator summed from the unrounded p. Inputs are made from a seed with
numpy at Zamba2-smoke widths (4 heads of 64), bf16.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.configs import registry
from repro_torch.kernels import madc as madc_mod
from repro_torch.kernels import ref
from repro_torch.kernels import swa_attention as swa_mod

TC_TOL = 1e-2           # the bf16 route against the fp32 plain version
NEG = -1e30


# ---------------------------------------------------------------------------
# swa_attention routes
# ---------------------------------------------------------------------------

def test_zamba2_prefill_takes_the_tensor_core_route():
    cfg = registry.get("zamba2-1.2b")
    assert cfg.dtype == "bfloat16"
    assert swa_mod._route(torch.bfloat16, torch.bfloat16,
                          cfg.head_dim) == "tc"


@pytest.mark.parametrize("dq,dkv,hd,route", [
    (torch.bfloat16, torch.bfloat16, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, "tc"),
    (torch.float32, torch.float32, 64, "fp32"),     # Zamba2 fp32 forward
    (torch.bfloat16, torch.float32, 64, "fp32"),
    (torch.float32, torch.bfloat16, 64, "fp32"),
    (torch.bfloat16, torch.bfloat16, 40, "fp32"),
    (torch.bfloat16, torch.bfloat16, 80, "fp32"),
    (torch.bfloat16, torch.bfloat16, 256, "fp32"),
])
def test_route_depends_on_dtype_and_head_dim_only(dq, dkv, hd, route):
    assert swa_mod._route(dq, dkv, hd) == route


def test_tma_rules_are_checked_on_the_strides():
    base = torch.zeros((2, 8, 2, 72), dtype=torch.bfloat16)
    assert swa_mod._tma_strides("q", base[..., :64]) == (8 * 2 * 72, 2 * 72,
                                                         72)
    with pytest.raises(ValueError, match="16 bytes"):
        swa_mod._tma_strides("q", torch.zeros((2, 8, 2, 68),
                                              dtype=torch.bfloat16)[..., :64])
    # a dim of size 1 is never stepped: its stride is not held to the rule
    one = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    assert swa_mod._tma_strides("k", one[:, :, :, :]) == (512, 64, 64)


# ---------------------------------------------------------------------------
# madc: the 1-D grid over the upper triangle of output tiles
# ---------------------------------------------------------------------------

def test_madc_tiles_fill_the_card_at_the_main_paths_n():
    tile = madc_mod.madc_tiles(100)             # n = α·m on the main path
    T = -(-100 // tile)
    assert T * (T + 1) // 2 >= 16
    assert all(madc_mod.madc_tiles(n) in madc_mod.TILES
               for n in (1, 100, 1023, 1024, 1279, 1280, 10_000))


@pytest.mark.parametrize("lo,hi", [(1, 100), (100, 200), (200, 301)])
def test_madc_grid_covers_the_upper_triangle_once(lo, hi):
    for n in range(lo, hi):
        tile = madc_mod.madc_tiles(n)
        T = -(-n // tile)
        computed = np.zeros((n, n), np.int32)     # tiles the grid computes
        written = np.zeros((n, n), np.int32)      # with the mirrored writes
        for t in range(T * (T + 1) // 2):
            ti, tj = madc_mod.madc_tile_of(t)
            assert 0 <= ti <= tj < T
            rows = slice(ti * tile, (ti + 1) * tile)
            cols = slice(tj * tile, (tj + 1) * tile)
            computed[rows, cols] += 1
            written[rows, cols] += 1
            if ti != tj:
                written[cols, rows] += 1
        i, j = np.indices((n, n))
        upper = (i // tile) <= (j // tile)
        np.testing.assert_array_equal(computed, upper.astype(np.int32))
        assert (written == 1).all(), n


def test_madc_tile_of_matches_the_closed_form_far_out():
    for t in list(range(2000)) + [10 ** 6 + 7, 2 ** 31 - 2]:
        a = (math.isqrt(8 * t + 1) - 1) // 2
        assert madc_mod.madc_tile_of(t) == (t - a * (a + 1) // 2, a)


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic, emulated
# ---------------------------------------------------------------------------

def tc_emulation(q, k, v, *, window, causal):
    """``swa_attention_tc.cu``'s arithmetic in torch: (B, Sq, H, hd) bf16
    q, (B, Sk, KV, hd) bf16 k/v -> (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    c = (1.0 / hd ** 0.5) * math.log2(math.e)
    off = Sk - Sq
    kk = k.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vv = v.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    qq = q.float().transpose(1, 2)                       # (B, H, Sq, hd)
    out = torch.zeros((B, H, Sq, hd))
    for q0 in range(0, Sq, 128):
        rows = torch.arange(q0, min(q0 + 128, Sq))
        qpos = rows + off
        pmin, pmax = int(qpos[0]), int(qpos[-1])
        k_lo = max(0, pmin - window + 1) if window else 0
        k_hi = min(Sk, pmax + 1) if causal else Sk
        m = torch.full((B, H, len(rows)), NEG)
        l = torch.zeros((B, H, len(rows)))
        o = torch.zeros((B, H, len(rows), hd))
        for k0 in range(k_lo // 128 * 128, k_hi, 128):
            keys = torch.arange(k0, min(k0 + 128, Sk))
            s = qq[:, :, rows] @ kk[:, :, keys].transpose(-1, -2)
            ok = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                ok &= keys[None] <= qpos[:, None]
            if window:
                ok &= keys[None] > qpos[:, None] - window
            s = torch.where(ok, s, torch.tensor(NEG))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2((m - mx) * c)
            mc = torch.where(mx == NEG, 0.0, mx * c)
            p = torch.exp2(s * c - mc[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + (p.to(torch.bfloat16).float()
                                       @ vv[:, :, keys])
            m = mx
        out[:, :, rows] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


def _bf16_inputs(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(B, S, h, hd)).astype(np.float32)
                            ).to(torch.bfloat16)
            for S, h in ((Sq, H), (Sk, KV), (Sk, KV))]


def _max_excess(got, want, tol):
    """max of |got − want| − tol·(1 + |want|): <= 0 where allclose holds."""
    return float(((got - want).abs() - tol * (1 + want.abs())).max())


@pytest.mark.parametrize("Sq,Sk,KV,window,causal", [
    (300, 300, 4, None, True),        # three query tiles, ragged last one
    (300, 300, 4, 64, True),          # rows whose first tile is all masked
    (300, 300, 2, None, False),       # bidirectional, grouped kv heads
    (40, 333, 4, 512, True),          # decode-style tail, Sk ragged
])
def test_tc_emulation_fits_the_bf16_tolerance(Sq, Sk, KV, window, causal):
    cfg = registry.smoke_variant(registry.get("zamba2-1.2b"))
    q, k, v = _bf16_inputs(Sq + Sk, 2, Sq, Sk, cfg.n_heads, KV,
                           cfg.head_dim)
    got = tc_emulation(q, k, v, window=window, causal=causal)
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TC_TOL, rtol=TC_TOL)
    # the error is P's bf16 rounding: visible, and well inside the bound
    err = float((got - want).abs().max())
    assert 1e-5 < err < TC_TOL / 2


def test_jax_sdpa_rounds_like_the_tc_route():
    """The JAX zoo's ``sdpa`` casts the probabilities to bf16, as the
    tensor-core route does; against the Pallas kernel (interpret mode,
    probabilities in fp32) it differs by the same order as the emulation
    does against the plain version."""
    B, S, H, hd, window = 1, 256, 4, 64, 64
    q, k, v = _bf16_inputs(7, B, S, S, H, H, hd)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    pallas = np.array(jops.sliding_window_attention(
        jq, jk, jv, window=window, causal=True), np.float32)
    bias = jattn.make_mask_bias(S, S, causal=True, window=window)
    sdpa = np.array(jattn.sdpa(jq, jk, jv, bias, 1.0 / hd ** 0.5),
                      np.float32)
    jax_err = float(np.abs(sdpa - pallas).max())
    emu = tc_emulation(q, k, v, window=window, causal=True)
    emu_err = float((emu - torch.as_tensor(pallas)).abs().max())
    assert _max_excess(torch.as_tensor(sdpa), torch.as_tensor(pallas),
                       TC_TOL) <= 0
    assert _max_excess(emu, torch.as_tensor(pallas), TC_TOL) <= 0
    assert 0.1 < emu_err / jax_err < 10, (emu_err, jax_err)
