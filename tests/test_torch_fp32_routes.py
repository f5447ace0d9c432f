"""The fp32 routes of ``swa_attention`` and ``ssd_intra_chunk``, on the
CPU: which inputs take them, how their grids cover the work, and — by a
torch emulation of ``csrc/swa_attention.cu`` and ``csrc/ssd_chunk.cu`` —
that their arithmetic meets the routes' tolerances (3e-5, 2e-4) against
the JAX package's kernels, and why it needs three TF32 terms a product.

The emulations repeat the kernels step by step:
- every fp32 operand x of a product is split as the kernels'
  ``tf32x3::split`` does: big = x truncated to TF32 (10 explicit
  significand bits), small = x − big, read by the tensor core as TF32
  (emulated as truncation, the worse of truncating and rounding); each
  k-step of 8 adds small·big, then big·small, then big·big into the fp32
  accumulator (``mma3_row``);
- SWA: 128-row query tiles, key tiles of 64, 32 or 16 (``block_k``), the
  tiles ``key_tiles`` gives, split into chunks by ``swa_plan``; masked
  scores −1e30 and p = 0 for them; an online softmax in base 2; P·V in
  k-steps of 8 keys; the chunks' (m, l, acc) combined with 2^(m_j − M);
- SSD: G = C·Bᵀ in k-steps of 8 over N; S = G ⊙ L with L a select on
  j <= i of 2^((a_i − a_j)·log2 e); Y_diag = S·X and state = (X ⊙ w)ᵀ B
  in k-steps of 8 keys, w_k = 2^((a_last − a_k)·log2 e).
The tensor cores' own order of the 8 products inside one k-step is not
emulated (fp32 matmul of the 8); ``ex2.approx`` is emulated by exp2.
Inputs are made from a seed with numpy; the JAX kernels run in interpret
mode, as tests/test_kernels.py runs them.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels import swa_attention as swa_mod

TOL = 3e-5              # swa_attention's fp32 route
SSD_TOL = 2e-4          # ssd_intra_chunk's routes
LOG2E = math.log2(math.e)
NEG = -1e30
N_SM = 132              # the H100's SMs, as the wrappers read them
bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16


# ---------------------------------------------------------------------------
# routes: every input the old CUDA-core kernels took still goes to fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dq,dkv,hd", [
    (f32, f32, 64), (f32, f32, 128), (f32, f32, 40), (f32, f32, 256),
    (bf, f32, 64), (f32, bf, 64), (bf, f32, 128), (f32, bf, 80),
    (bf, bf, 40), (bf, bf, 80), (bf, bf, 192), (bf, bf, 256), (bf, bf, 1),
])
def test_swa_fp32_route_takes_what_the_tc_route_does_not(dq, dkv, hd):
    assert swa_mod._route(dq, dkv, hd) == "fp32"


@pytest.mark.parametrize("dx,dbc,Q,P,N", [
    (f32, f32, 128, 64, 64), (f32, f32, 64, 64, 64), (f32, f32, 37, 23, 11),
    (f32, f32, 128, 64, 128), (bf, bf, 37, 64, 64), (bf, bf, 128, 32, 64),
    (bf, bf, 128, 64, 100), (bf, f32, 128, 64, 64), (f32, bf, 64, 64, 64),
    (f16, f16, 128, 64, 64),
])
def test_ssd_fp32_route_takes_what_the_tc_route_does_not(dx, dbc, Q, P, N):
    assert ssd_mod._route(dx, dbc, Q, P, N) == "fp32"


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def _kept(Sq, Sk, window, causal):
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    kpos = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def swa_ctas(BH, Sq, Sk, hd, window, causal, n_sm=N_SM):
    """The fp32 kernel's working CTAs: (query tile, first key tile, end)."""
    chunk, nsplit = swa_mod.swa_plan(BH, Sq, Sk, hd, window, causal, n_sm)
    bk = swa_mod.block_k(hd)
    out = []
    for qt in range(-(-Sq // swa_mod.BLOCK_Q)):
        lo, hi = swa_mod.key_tiles(qt, Sq, Sk, bk, window, causal)
        nch = -(-(hi - lo) // chunk)
        assert nch <= nsplit
        for sp in range(nch):
            out.append((qt, lo + sp * chunk, min(hi, lo + (sp + 1) * chunk)))
    return out, chunk, nsplit


SWA_GRIDS = [
    (32, 256, 256, 64, None, True),       # Zamba2's fp32 forward
    (32, 256, 256, 64, 64, True),         # ... with a 64 window
    (128, 2048, 2048, 64, None, True),    # Zamba2's fp32 prefill
    (128, 2048, 2048, 64, 512, True),
    (4, 33, 65, 40, 16, True),            # unaligned
    (2, 96, 96, 80, None, False),         # bidirectional
    (8, 70, 70, 256, 20, True),
    (3, 5, 300, 128, 7, False),           # decode-style tail
    (1, 1, 2048, 64, None, True),
    (1, 1, 100_000, 64, None, True),      # long decode tail: chunks capped
]


@pytest.mark.parametrize("BH,Sq,Sk,hd,window,causal", SWA_GRIDS)
def test_swa_grid_covers_every_kept_key_once(BH, Sq, Sk, hd, window, causal):
    ctas, chunk, nsplit = swa_ctas(BH, Sq, Sk, hd, window, causal)
    bk, bq = swa_mod.block_k(hd), swa_mod.BLOCK_Q
    seen = np.zeros((Sq, Sk), np.int32)       # (query, key) pairs visited
    for qt, t0, t1 in ctas:
        rows = slice(qt * bq, min(qt * bq + bq, Sq))
        seen[rows, t0 * bk:t1 * bk] += 1
    assert seen.max() == 1                    # no key twice for a row
    assert (seen[_kept(Sq, Sk, window, causal)] == 1).all()
    assert all(t1 - t0 <= chunk for _, t0, t1 in ctas)
    assert nsplit <= swa_mod.MAX_SPLIT        # the combine kernel's cap


def test_swa_plan_splits_where_the_grid_is_small():
    # Zamba2's fp32 forward: 2 query tiles x 32 heads would be 64 CTAs,
    # the last walking 4 key tiles; split, one key tile a CTA: 192 CTAs
    ctas, chunk, nsplit = swa_ctas(32, 256, 256, 64, None, True)
    assert (chunk, nsplit) == (1, 4) and 32 * len(ctas) == 192
    # the prefill fills the card unsplit: no partials, no combine
    assert swa_mod.swa_plan(128, 2048, 2048, 64, None, True,
                            N_SM) == (32, 1)


def ssd_cover(b, c, h, per_head, n_sm=N_SM):
    """Which CTA of the fp32 kernels' grid writes each cell, decoded as the
    kernels decode blockIdx.x (hb = 1: the one-cell kernel, a CTA a cell)."""
    hb = ssd_mod.ssd_heads_per_cta(b, c, h, per_head, n_sm)
    n_hb = -(-h // hb)
    cells = np.zeros((b, c, h), np.int32)
    for cta in range(b * c * n_hb):
        hbi, bc = cta % n_hb, cta // n_hb
        h0 = hbi * hb
        for hh in range(h0, min(h0 + hb, h)):
            cells[bc // c, bc % c, hh] += 1
    return hb, b * c * n_hb, cells


@pytest.mark.parametrize("b,c,h,per_head,hb", [
    (1, 2, 64, False, 1),        # Zamba2's fp32 forward: 128 one-cell CTAs
    (4, 16, 64, False, 16),      # its fp32 prefill: 256 CTAs of 16 heads
    (4, 16, 64, True, 1),        # B/C per head: never shared
    (256, 16, 1, False, 1),      # the Pallas cells layout
    (4, 16, 13, False, 4),       # a last block of 1 head
    (2, 3, 5, False, 1),
])
def test_ssd_grid_covers_every_cell_once(b, c, h, per_head, hb):
    got, ctas, cells = ssd_cover(b, c, h, per_head)
    assert got == hb
    assert (cells == 1).all()
    if hb > 1:                   # a larger block would leave SMs idle
        assert ctas >= N_SM > b * c * -(-h // (2 * hb))


def ssd_warp_tiles(w: int) -> list:
    """(row block, column tile) pairs of C·Bᵀ that warp w of
    ``csrc/ssd_chunk.cu`` computes: row blocks w and 7 − w of 16 rows,
    column tiles of 8 up to each block's diagonal."""
    return ([(w, u) for u in range(2 * w + 2)]
            + [(7 - w, u) for u in range(16 - 2 * w)])


def test_ssd_warps_split_the_causal_triangle_evenly():
    owned = np.zeros((8, 16), np.int32)
    for w in range(4):
        tiles = ssd_warp_tiles(w)
        assert len(tiles) == 18               # the kernel's gr[18][4]
        for rb, jt in tiles:
            owned[rb, jt] += 1
    rb, jt = np.indices((8, 16))
    np.testing.assert_array_equal(owned, (8 * jt <= 16 * rb + 15))


# ---------------------------------------------------------------------------
# the arithmetic, emulated
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: the low 13 bits of its fp32 pattern cleared (the
    kernels' ``split`` for big; the tensor core's reading of small)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the kernels' ``mma3`` k-steps of 8:
    small·big, big·small, big·big (terms=1: big·big only)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ab, as_ = split(a[..., k0:k0 + 8])
        bb, bs = split(b[..., k0:k0 + 8, :])
        if terms == 3:
            acc = acc + as_ @ bb
            acc = acc + ab @ bs
        acc = acc + ab @ bb
    return acc


def swa_emulation(q, k, v, *, window, causal, terms=3, n_sm=N_SM):
    """``swa_attention.cu``'s arithmetic: (B, Sq, H, hd) q, (B, Sk, KV, hd)
    k/v (fp32 or bf16) -> (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    c = (1.0 / hd ** 0.5) * LOG2E
    bk = swa_mod.block_k(hd)
    qq = q.float().transpose(1, 2)                       # (B, H, Sq, hd)
    kk = k.float().repeat_interleave(H // KV, 2).transpose(1, 2)
    vv = v.float().repeat_interleave(H // KV, 2).transpose(1, 2)
    pad = -(-Sk // bk) * bk - Sk                         # zero-filled keys
    kk = torch.nn.functional.pad(kk, (0, 0, 0, pad))
    vv = torch.nn.functional.pad(vv, (0, 0, 0, pad))
    ok_all = torch.as_tensor(np.pad(_kept(Sq, Sk, window, causal),
                                    ((0, 0), (0, pad))))
    chunk, _ = swa_mod.swa_plan(B * H, Sq, Sk, hd, window, causal, n_sm)
    out = torch.zeros((B, H, Sq, hd))
    bq = swa_mod.BLOCK_Q
    for qt in range(-(-Sq // bq)):
        rows = slice(qt * bq, min(qt * bq + bq, Sq))
        lo, hi = swa_mod.key_tiles(qt, Sq, Sk, bk, window, causal)
        parts = []
        for t0 in range(lo, hi, chunk):
            n = rows.stop - rows.start
            m = torch.full((B, H, n), NEG)
            l = torch.zeros((B, H, n))
            o = torch.zeros((B, H, n, hd))
            for tile in range(t0, min(hi, t0 + chunk)):
                keys = slice(tile * bk, tile * bk + bk)
                ok = ok_all[rows, keys]
                s = mm3(qq[:, :, rows], kk[:, :, keys].transpose(-1, -2),
                        terms)
                s = torch.where(ok, s * c, torch.tensor(NEG))
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.where(ok, torch.exp2(s - mx[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + mm3(p, vv[:, :, keys], terms)
                m = mx
            parts.append((m, l, o))
        if len(parts) == 1:
            m, l, o = parts[0]
            out[:, :, rows] = o / torch.clamp(l, min=1e-30)[..., None]
            continue
        M = torch.stack([p[0] for p in parts]).amax(0)
        wts = [torch.exp2(p[0] - M) for p in parts]
        L = sum(p[1] * w_ for p, w_ in zip(parts, wts))
        acc = sum(p[2] * w_[..., None] for p, w_ in zip(parts, wts))
        out[:, :, rows] = acc / torch.clamp(L, min=1e-30)[..., None]
    return out.transpose(1, 2)


def ssd_emulation(Xc, A_cs, Bc, Cc, terms=3):
    """``ssd_chunk.cu``'s arithmetic in the model's layout: Xc (b, c, Q,
    h, p), Bc, Cc (b, c, Q, h, n), A_cs (b, h, c, Q) -> (Y_diag (b, c, Q,
    h, p), states (b, c, h, p, n)) fp32."""
    b, c, Q, h, p = Xc.shape
    n = Bc.shape[-1]
    X, B, C = (t.float().permute(0, 1, 3, 2, 4) for t in (Xc, Bc, Cc))
    n8 = -(-n // 8) * 8                                 # zero-padded N
    B8 = torch.nn.functional.pad(B, (0, n8 - n))
    C8 = torch.nn.functional.pad(C, (0, n8 - n))
    a = A_cs.permute(0, 2, 1, 3)                        # (b, c, h, Q)
    G = mm3(C8, B8.transpose(-1, -2), terms)            # (b, c, h, Q, Q)
    idx = torch.arange(Q)
    keep = idx[None, :] <= idx[:, None]
    L = torch.exp2((a[..., :, None] - a[..., None, :]) * LOG2E)
    S = torch.where(keep, G * L, torch.zeros(()))
    Y = mm3(S, X, terms)
    w = torch.exp2((a[..., -1:] - a) * LOG2E)
    state = mm3((X * w[..., None]).transpose(-1, -2), B, terms)
    return Y.permute(0, 1, 3, 2, 4), state


def _max_excess(got, want, tol):
    """max of |got − want| − tol·(1 + |want|): <= 0 where allclose holds."""
    return float(((got - want).abs() - tol * (1 + want.abs())).max())


def _swa_inputs(seed, B, Sq, Sk, H, KV, hd, dq=f32, dkv=f32):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(B, S, hh, hd)).astype(
        np.float32)).to(dt) for S, hh, dt in ((Sq, H, dq), (Sk, KV, dkv),
                                              (Sk, KV, dkv))]


def _jax_swa(q, k, v, window, causal):
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    return torch.as_tensor(np.array(jops.sliding_window_attention(
        jq, jk, jv, window=window, causal=causal), np.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,hd,window,causal", [
    (1, 256, 256, 4, 64, None, True),     # Zamba2's fp32 forward, split KV
    (1, 256, 256, 4, 64, 64, True),       # rows whose first tile is masked
    (2, 33, 65, 2, 40, 16, True),         # unaligned, Sq < Sk
    (1, 96, 96, 2, 80, None, False),      # bidirectional, key tiles of 32
])
def test_swa_emulation_matches_the_pallas_kernel(B, Sq, Sk, H, hd, window,
                                                 causal):
    q, k, v = _swa_inputs(Sq + hd, B, Sq, Sk, H, H, hd)
    got = swa_emulation(q, k, v, window=window, causal=causal)
    want = _jax_swa(q, k, v, window, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dq,dkv,KV", [(f32, f32, 2), (bf, f32, 4),
                                       (f32, bf, 1)])
def test_swa_emulation_takes_mixed_dtypes_and_grouped_heads(dq, dkv, KV):
    q, k, v = _swa_inputs(11, 2, 70, 100, 4, KV, 48, dq, dkv)
    got = swa_emulation(q, k, v, window=30, causal=True)
    want = ref.swa_attention_ref(q, k, v, window=30, causal=True)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_swa_split_combine_equals_one_pass():
    """The split-KV partials, combined, agree with one pass over all key
    tiles (a plan on a card of 10,000 SMs splits every tile; one of 1 SM
    never splits)."""
    q, k, v = _swa_inputs(5, 1, 200, 200, 2, 2, 64)
    assert swa_mod.swa_plan(2, 200, 200, 64, None, True, 10_000)[0] == 1
    assert swa_mod.swa_plan(2, 200, 200, 64, None, True, 1)[1] == 1
    split_ = swa_emulation(q, k, v, window=None, causal=True, n_sm=10_000)
    whole = swa_emulation(q, k, v, window=None, causal=True, n_sm=1)
    torch.testing.assert_close(split_, whole, atol=2e-6, rtol=2e-6)


def test_swa_one_tf32_term_misses_the_tolerance():
    """Why three terms: one TF32 term keeps ~3 decimal digits of q·k, and
    the scores' error reaches the output far above 3e-5; three meet it."""
    q, k, v = _swa_inputs(2, 1, 128, 128, 2, 2, 64)
    want = ref.swa_attention_ref(q, k, v, window=None, causal=True)
    one = swa_emulation(q, k, v, window=None, causal=True, terms=1)
    three = swa_emulation(q, k, v, window=None, causal=True, terms=3)
    assert _max_excess(one, want, TOL) > 0
    assert _max_excess(three, want, TOL) < 0


def _ssd_inputs(seed, decay, per_head, b=1, c=2, Q=128, h=4, p=64, n=64):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    X = f(b, c, Q, h, p)
    if per_head:
        Bc, Cc = f(b, c, Q, h, n), f(b, c, Q, h, n)
    else:
        Bc, Cc = (f(b, c, Q, 1, n).expand(b, c, Q, h, n) for _ in range(2))
    raw = rng.normal(size=(b, h, c, Q)).astype(np.float32)
    dtA = -decay * np.log1p(np.exp(raw))                # −s·softplus
    return X, torch.cumsum(torch.as_tensor(dtA), -1), Bc, Cc


def _jax_ssd(X, A_cs, Bc, Cc):
    b, c, Q, h, p = X.shape

    def cells(t):                                       # (b·h, c, Q, ·)
        return jnp.asarray(t.float().permute(0, 3, 1, 2, 4).reshape(
            b * h, c, Q, -1).numpy())
    Yj, Sj = jops.ssd_chunk_block(cells(X), jnp.asarray(
        A_cs.reshape(b * h, c, Q).numpy()), cells(Bc), cells(Cc))
    Y = torch.as_tensor(np.array(Yj)).reshape(b, h, c, Q, p).permute(
        0, 2, 3, 1, 4)
    S = torch.as_tensor(np.array(Sj)).reshape(b, h, c, -1, p).permute(
        0, 2, 1, 4, 3)                                  # (N, P) -> (P, N)
    return Y, S


@pytest.mark.parametrize("decay,per_head,shape", [
    (1.0, False, {}), (0.01, False, {}), (1.0, True, {}), (0.01, True, {}),
    (0.01, True, dict(Q=37, p=23, n=11, c=3, h=2)),     # unaligned
    (1.0, False, dict(Q=64, n=100, h=3)),               # N past 64
])
def test_ssd_emulation_matches_the_pallas_kernel(decay, per_head, shape):
    args = _ssd_inputs(3, decay, per_head, **shape)
    Y, S = ssd_emulation(*args)
    Yj, Sj = _jax_ssd(*args)
    assert torch.isfinite(Y).all() and torch.isfinite(S).all()
    torch.testing.assert_close(Y, Yj, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sj, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("decay", [1.0, 0.01])
def test_ssd_emulation_meets_the_tolerance_against_plain(decay):
    args = _ssd_inputs(7, decay, False)
    Y, S = ssd_emulation(*args)
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    assert _max_excess(Y, Yr, SSD_TOL) < 0
    assert _max_excess(S, Sr, SSD_TOL) < 0


def test_ssd_one_tf32_term_misses_the_tolerance():
    """Why three terms: with X, B and C in fp32, one TF32 term a product
    leaves ~2^-11 of every product, and over a chunk where L ~ 1 the error
    of Y_diag passes 2e-4·(1 + |Y|); three terms meet it."""
    args = _ssd_inputs(3, 0.01, False)
    Yr, _ = ref.ssd_intra_chunk_ref(*args)
    assert _max_excess(ssd_emulation(*args, terms=1)[0], Yr, SSD_TOL) > 0
    assert _max_excess(ssd_emulation(*args, terms=3)[0], Yr, SSD_TOL) < 0


def test_tf32_split_keeps_22_bits():
    x = torch.as_tensor(np.random.default_rng(1).normal(
        scale=10.0, size=4096).astype(np.float32))
    big, small = split(x)
    for t in (big, small):                       # TF32 patterns
        assert not (t.view(torch.int32) & 0x1FFF).any()
    rel = ((big + small - x).abs() / x.abs()).max()
    assert rel <= 2.0 ** -21
    assert ((big - x).abs() / x.abs()).max() > 2.0 ** -13   # one term: ~11
