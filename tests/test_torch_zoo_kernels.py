"""The zoo's two kernels in the PyTorch port, on the CPU (their plain
versions), against the JAX package's Pallas kernels in interpret mode and
its jnp oracles, on the same inputs made from a seed with numpy.

Tolerances, as tests/test_kernels.py holds the Pallas kernels: SWA fp32
3e-5, bf16 2e-2; SSD intra-chunk fp32 2e-4, bf16 3e-2 (the two frameworks
sum in another order; bf16 inputs are rounded alike, the sums are fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk, ssd_intra_chunk_cells
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import ssm as tssm

SWA_TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SSD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
           "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype))
    t = torch.as_tensor(a, dtype=torch.float32).to(getattr(torch, dtype))
    return j, t


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# swa_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,hd,window,causal", [
    (2, 64, 64, 2, 64, None, True),
    (1, 128, 128, 4, 64, 32, True),
    (2, 1, 256, 2, 128, 64, True),      # decode tail: 1 query vs cache
    (1, 96, 96, 2, 80, None, False),    # encoder (bidirectional)
    (1, 256, 256, 1, 128, 128, True),
    (2, 33, 65, 2, 40, 16, True),       # nothing aligned
])
def test_swa_plain_matches_pallas_kernel(B, Sq, Sk, H, hd, window, causal):
    rng = np.random.default_rng(B * Sq + Sk)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    want = jops.sliding_window_attention(jq, jk, jv, window=window,
                                         causal=causal, block_q=32,
                                         block_k=32)
    got = swa_attention(tq, tk, tv, window=window, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), _np(want), **SWA_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_plain_dtypes(dtype):
    rng = np.random.default_rng(9)
    arrs = [rng.normal(size=(1, 64, 2, 64)).astype(np.float32)
            for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrs)
    want = jops.sliding_window_attention(jq, jk, jv, window=16)
    got = swa_attention(tq, tk, tv, window=16)
    np.testing.assert_allclose(got.numpy(), _np(want), **SWA_TOL[dtype])


def test_swa_plain_reads_grouped_kv_heads():
    """KV < H: head h reads kv head h // (H/KV), as a repeated copy would."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
    want = jref.swa_attention_ref(jnp.asarray(q), jnp.repeat(k, 2, axis=2),
                                  jnp.repeat(v, 2, axis=2), window=8)
    got = swa_attention(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), window=8)
    np.testing.assert_allclose(got.numpy(), _np(want), **SWA_TOL["float32"])


def test_swa_window_larger_than_sequence_equals_full():
    rng = np.random.default_rng(10)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 64, 2, 64)),
                               dtype=torch.float32) for _ in range(3))
    torch.testing.assert_close(swa_attention(q, k, v, window=None),
                               swa_attention(q, k, v, window=4096),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw,match", [
    (dict(q=(1, 9, 2, 8), k=(1, 8, 2, 8)), "0 < Sq <= Sk"),
    (dict(q=(1, 4, 3, 8), k=(1, 8, 2, 8)), "multiple of KV"),
    (dict(q=(1, 4, 2, 8), k=(1, 8, 2, 8), window=0), "keeps no key"),
])
def test_swa_wrapper_refuses_bad_shapes(kw, match):
    window = kw.pop("window", None)
    q, k = torch.zeros(kw["q"]), torch.zeros(kw["k"])
    with pytest.raises(ValueError, match=match):
        swa_attention(q, k, k, window=window)


# ---------------------------------------------------------------------------
# ssd_intra_chunk
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, BH, NC, Q, P, N):
    X = rng.normal(size=(BH, NC, Q, P)).astype(np.float32)
    raw = rng.normal(size=(BH, NC, Q)).astype(np.float32)
    dtA = -np.log1p(np.exp(raw))                     # -softplus
    A_cs = np.cumsum(dtA, -1).astype(np.float32)
    B = rng.normal(size=(BH, NC, Q, N)).astype(np.float32)
    C = rng.normal(size=(BH, NC, Q, N)).astype(np.float32)
    return X, dtA, A_cs, B, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,NC,Q,P,N", [
    (4, 2, 16, 8, 4),                  # tests/test_kernels.py's dtype case
    (4, 3, 32, 16, 8),
    (3, 2, 24, 12, 5),                 # nothing aligned
])
def test_ssd_plain_matches_pallas_kernel(dtype, BH, NC, Q, P, N):
    rng = np.random.default_rng(BH * 100 + Q)
    X, _, A_cs, B, C = _ssd_inputs(rng, BH, NC, Q, P, N)
    (jX, tX), (jB, tB), (jC, tC) = (_both(a, dtype) for a in (X, B, C))
    Yj, Sj = jops.ssd_chunk_block(jX, jnp.asarray(A_cs), jB, jC)
    Yt, St = ssd_intra_chunk_cells(tX, torch.as_tensor(A_cs), tB, tC)
    assert Yt.dtype == St.dtype == torch.float32
    assert St.shape == (BH, NC, N, P)
    np.testing.assert_allclose(Yt.numpy(), _np(Yj), **SSD_TOL[dtype])
    np.testing.assert_allclose(St.numpy(), _np(Sj), **SSD_TOL[dtype])


def test_ssd_plain_matches_sequential_oracle():
    """One chunk from a zero state: Y_diag is the recurrence's output and
    the chunk state its final state (tests/test_kernels.py's
    ``test_matches_model_ssd_path``, held to the port's own oracle)."""
    rng = np.random.default_rng(7)
    b, l, h, p, n = 2, 32, 2, 8, 4
    X = torch.as_tensor(rng.normal(size=(b, l, h, p)), dtype=torch.float32)
    dtA = -torch.nn.functional.softplus(
        torch.as_tensor(rng.normal(size=(b, l, h)), dtype=torch.float32))
    B = torch.as_tensor(rng.normal(size=(b, l, h, n)), dtype=torch.float32)
    C = torch.as_tensor(rng.normal(size=(b, l, h, n)), dtype=torch.float32)
    A_cs = torch.cumsum(dtA.permute(0, 2, 1)[:, :, None], -1)   # (b,h,1,l)
    Y, S = ssd_intra_chunk(X[:, None], A_cs, B[:, None], C[:, None])
    Yr, Sr = ref.ssd_chunk_ref(X, dtA, B, C)
    torch.testing.assert_close(Y[:, 0], Yr, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(S[:, 0], Sr, atol=2e-4, rtol=2e-4)
    Yj, Sj = jref.ssd_chunk_ref(*(jnp.asarray(t.numpy())
                                  for t in (X, dtA, B, C)))
    np.testing.assert_allclose(Yr.numpy(), _np(Yj), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(Sr.numpy(), _np(Sj), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """Kernel steps 1-2 (plain here) + the port's steps 3-4 == the JAX
    package's ``ssd_chunked``, over 4 chunks with head-expanded B/C as a
    stride-0 view."""
    rng = np.random.default_rng(11)
    b, l, h, p, n, Q = 2, 64, 3, 8, 4, 16
    X = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dtA = -np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    Bg = rng.normal(size=(b, l, 1, n)).astype(np.float32)
    Cg = rng.normal(size=(b, l, 1, n)).astype(np.float32)
    init = (rng.normal(size=(b, h, p, n)).astype(np.float32)
            if with_state else None)
    Yj, Fj = jssm.ssd_chunked(jnp.asarray(X), jnp.asarray(dtA),
                              jnp.repeat(Bg, h, 2), jnp.repeat(Cg, h, 2), Q,
                              None if init is None else jnp.asarray(init))
    Bt = torch.as_tensor(Bg).expand(b, l, h, n)
    Ct = torch.as_tensor(Cg).expand(b, l, h, n)
    Yt, Ft = tssm.ssd_chunked(torch.as_tensor(X), torch.as_tensor(dtA), Bt,
                              Ct, Q, None if init is None
                              else torch.as_tensor(init))
    np.testing.assert_allclose(Yt.numpy(), _np(Yj), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(Ft.numpy(), _np(Fj), atol=2e-4, rtol=2e-4)


def test_segsum_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(tssm._segsum(torch.as_tensor(x)).numpy(),
                               _np(jssm._segsum(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_ssd_wrapper_refuses_bad_shapes():
    X = torch.zeros((1, 2, 16, 1, 8))
    A = torch.zeros((1, 1, 2, 16))
    B = torch.zeros((1, 2, 16, 1, 4))
    with pytest.raises(ValueError, match="want X"):
        ssd_intra_chunk(X, A[..., :8], B, B)


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    q = torch.zeros((1, 4, 2, 8))
    swa_attention(q, q, q)
    X, _, A_cs, B, C = _ssd_inputs(np.random.default_rng(0), 2, 1, 8, 4, 4)
    ssd_intra_chunk_cells(*(torch.as_tensor(a) for a in (X, A_cs, B, C)))
    assert ops.launch_counts() == {"edc_cosine": 0, "madc": 0,
                                   "swa_attention": 0, "ssd_intra_chunk": 0,
                                   "swa_attention.tc": 0,
                                   "swa_attention.fp32": 0,
                                   "ssd_intra_chunk.tc": 0,
                                   "ssd_intra_chunk.fp32": 0}
