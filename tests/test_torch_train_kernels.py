"""The plain backward versions of the zoo's two kernels
(``kernels.ref.swa_attention_bwd_ref``, ``ssd_intra_chunk_bwd_ref``), on
the CPU, held two ways on inputs made from a seed with numpy: against
``torch.autograd.grad`` through the plain forward, and against ``jax.vjp``
of the JAX package's jnp functions (``repro.kernels.ref
.swa_attention_ref``; steps 1-2 of ``repro.models.ssm.ssd_chunked``, with
its own ``_segsum``). Then ``torch.autograd.gradcheck`` in float64 through
each ``autograd.Function``'s CPU branch, and the wrappers' checks.

Tolerances: against autograd 1e-5 of each gradient's largest magnitude
(the same fp32 arithmetic, summed in another order); against ``jax.vjp``
1e-5 for SWA and 1e-4 for SSD, whose dA_cs is a difference of row and
column sums that cancel (fp32 sums in another framework's order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_chunk import (SsdIntraChunkFn, ssd_intra_chunk,
                                           ssd_intra_chunk_bwd)
from repro_torch.kernels.swa_attention import (SwaAttentionFn, swa_attention,
                                               swa_attention_bwd)

# (B, Sq, Sk, H, KV, hd, window, causal)
SWA_CASES = [
    (2, 8, 8, 2, 2, 8, None, True),         # H/KV 1
    (1, 6, 11, 4, 2, 8, 4, True),           # Sq < Sk, a window, H/KV 2
    (1, 9, 9, 8, 1, 56, 3, True),           # MQA (H/KV 8), hd 56
    (2, 7, 7, 2, 1, 80, None, False),       # bidirectional, hd 80
    (1, 5, 9, 8, 1, 8, 5, False),           # bidirectional window, Sq < Sk
    (1, 12, 12, 4, 4, 8, 2, True),          # window 2: two keys a row
]
SWA_IDS = ["mha", "window-sq<sk", "mqa-hd56", "bidir-hd80", "bidir-window",
           "window2"]
# (b, c, Q, h, p, n, one B/C group over the heads, per-step decay scale)
SSD_CASES = [
    (2, 3, 8, 4, 4, 3, True, 0.1),
    (1, 2, 16, 3, 8, 5, False, 0.1),
    (1, 1, 5, 2, 3, 4, False, 0.1),         # Q not a power of two
    (1, 2, 8, 2, 4, 4, True, 20.0),         # fast decay: L underflows
]
SSD_IDS = ["group", "per-head", "Q5", "fast-decay"]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _swa_inputs(case, seed=0):
    B, Sq, Sk, H, KV, hd, window, causal = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _ssd_inputs(case, seed=0):
    b, c, Q, h, p, n, group, scale = case
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, c, Q, h, p)).astype(np.float32)
    A = (-rng.uniform(size=(b, h, c, Q)) * scale).astype(np.float32)
    hb = 1 if group else h
    Bm, Cm = (rng.normal(size=(b, c, Q, hb, n)).astype(np.float32)
              for _ in range(2))
    dY = rng.normal(size=(b, c, Q, h, p)).astype(np.float32)
    dS = rng.normal(size=(b, c, h, p, n)).astype(np.float32)
    return X, A, Bm, Cm, dY, dS


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(b, c, Q, 1 or h, n) -> (b, c, Q, h, n), a stride-0 view for 1."""
    return t.expand(*t.shape[:3], h, t.shape[-1])


# ---------------------------------------------------------------------------
# swa_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SWA_CASES, ids=SWA_IDS)
def test_swa_bwd_ref_matches_autograd(case):
    window, causal = case[6], case[7]
    q, k, v, do = (torch.as_tensor(a) for a in _swa_inputs(case))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.swa_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                    o.detach(), do, window=window,
                                    causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_err(g, w) <= 1e-5


@pytest.mark.parametrize("case", SWA_CASES, ids=SWA_IDS)
def test_swa_bwd_ref_matches_jax_vjp(case):
    B, Sq, Sk, H, KV, hd, window, causal = case
    q, k, v, do = _swa_inputs(case, seed=1)

    def f(q, k, v):     # the reference takes H kv heads: jnp.repeat
        return jref.swa_attention_ref(q, jnp.repeat(k, H // KV, axis=2),
                                      jnp.repeat(v, H // KV, axis=2),
                                      window=window, causal=causal)

    @jax.jit            # one program: op by op takes ~5x longer here
    def fwd_vjp(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)
    o, want = fwd_vjp(q, k, v, do)
    got = ref.swa_attention_bwd_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(np.array(o)), torch.as_tensor(do), window=window,
        causal=causal)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("case", [SWA_CASES[1], SWA_CASES[3]],
                         ids=["window-sq<sk", "bidir"])
def test_swa_function_gradcheck_float64(case):
    B, Sq, Sk, H, KV, _, window, causal = case
    q, k, v, _ = _swa_inputs((B, Sq, Sk, H, KV, 4, window, causal), seed=2)
    args = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
            for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: SwaAttentionFn.apply(q, k, v, window, causal), args)


def test_swa_grad_goes_through_the_function_and_no_grad_does_not():
    q, k, v, do = (torch.as_tensor(a) for a in _swa_inputs(SWA_CASES[1]))
    with torch.no_grad():
        plain = swa_attention(q, k, v, window=4)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = swa_attention(qg, k, v, window=4)
    assert type(out.grad_fn).__name__ == "SwaAttentionFnBackward"
    assert torch.equal(out.detach(), plain)
    (dq,) = torch.autograd.grad(out, qg, do)
    want = ref.swa_attention_bwd_ref(q, k, v, plain, do, window=4)[0]
    assert torch.equal(dq, want)
    bf = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(swa_attention(*bf, window=4), bf, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


def test_swa_bwd_checks_its_inputs_and_cpu_launches_nothing():
    q, k, v, do = (torch.as_tensor(a) for a in _swa_inputs(SWA_CASES[0]))
    with pytest.raises(ValueError, match="want q's"):
        swa_attention_bwd(q, k, v, q[:, :4], do)
    with pytest.raises(ValueError, match="do not match"):
        swa_attention_bwd(q, k[..., :4], v[..., :4], q, do)
    ops.reset_launch_counts()
    swa_attention_bwd(q, k, v, q, do)
    assert ops.backward_launch_counts() == {"swa_attention_bwd": 0,
                                            "ssd_intra_chunk_bwd": 0}


# ---------------------------------------------------------------------------
# ssd_intra_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_bwd_ref_matches_autograd(case):
    h = case[3]
    X, A, Bm, Cm, dY, dS = (torch.as_tensor(a) for a in _ssd_inputs(case))
    A_cs = torch.cumsum(A, dim=-1)
    X, A_cs, Bm, Cm = (t.clone().requires_grad_(True)
                       for t in (X, A_cs, Bm, Cm))
    Y, St = ref.ssd_intra_chunk_ref(X, A_cs, _heads(Bm, h), _heads(Cm, h))
    want = torch.autograd.grad((Y, St), (X, A_cs, Bm, Cm), (dY, dS))
    dX, dA, dB, dC = ref.ssd_intra_chunk_bwd_ref(
        X.detach(), A_cs.detach(), _heads(Bm.detach(), h),
        _heads(Cm.detach(), h), dY, dS)
    # dB, dC come dense per head: a group's gradient is their sum
    dB, dC = (d.sum(3, keepdim=True) if Bm.shape[3] == 1 else d
              for d in (dB, dC))
    for g, w in zip((dX, dA, dB, dC), want):
        assert torch.isfinite(g).all() and g.shape == w.shape
        assert rel_err(g, w) <= 1e-5


def _jax_steps12(X, A, Bc, Cc):
    """Steps 1-2 of ``repro.models.ssm.ssd_chunked`` (ssm.py:104-110), as a
    function of the per-step log decay A (b, h, c, Q)."""
    L = jnp.exp(jssm._segsum(A))
    Y_diag = jnp.einsum("bcqhn,bckhn,bhcqk,bckhp->bcqhp", Cc, Bc, L, X)
    A_cs = jnp.cumsum(A, axis=-1)
    decay_states = jnp.exp(A_cs[..., -1:] - A_cs)
    states = jnp.einsum("bckhn,bhck,bckhp->bchpn", Bc, decay_states, X)
    return Y_diag, states


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_bwd_ref_matches_jax_vjp(case):
    b, c, Q, h, p, n, group, _ = case
    X, A, Bm, Cm, dY, dS = _ssd_inputs(case, seed=1)
    Bh, Ch = (np.broadcast_to(m, (b, c, Q, h, n)).copy() for m in (Bm, Cm))
    want = jax.jit(lambda *a: jax.vjp(_jax_steps12, *a[:4])[1](a[4:]))(
        X, A, Bh, Ch, dY, dS)
    A_cs = torch.cumsum(torch.as_tensor(A), dim=-1)
    dX, dA_cs, dB, dC = ref.ssd_intra_chunk_bwd_ref(
        torch.as_tensor(X), A_cs, torch.as_tensor(Bh), torch.as_tensor(Ch),
        torch.as_tensor(dY), torch.as_tensor(dS))
    # the gradient of the per-step A is the reversed cumsum of dA_cs's
    dA = torch.flip(torch.cumsum(torch.flip(dA_cs, [-1]), -1), [-1])
    for g, w in zip((dX, dA, dB, dC), want):
        assert rel_err(g.numpy(), w) <= 1e-4


@pytest.mark.parametrize("case", [(1, 2, 4, 3, 2, 2, True, 0.1),
                                  (1, 1, 5, 2, 2, 3, False, 0.1)],
                         ids=["group", "Q5"])
def test_ssd_function_gradcheck_float64(case):
    h = case[3]
    X, A, Bm, Cm, _, _ = _ssd_inputs(case, seed=2)
    args = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
            for a in (X, np.cumsum(A, -1), Bm, Cm)]
    assert torch.autograd.gradcheck(
        lambda X, A_cs, Bm, Cm: SsdIntraChunkFn.apply(
            X, A_cs, _heads(Bm, h), _heads(Cm, h), None), args)


def test_ssd_grad_goes_through_the_function_and_no_grad_does_not():
    h = SSD_CASES[0][3]
    X, A, Bm, Cm, dY, dS = (torch.as_tensor(a)
                            for a in _ssd_inputs(SSD_CASES[0]))
    A_cs = torch.cumsum(A, -1)
    with torch.no_grad():
        Y, St = ssd_intra_chunk(X, A_cs, _heads(Bm, h), _heads(Cm, h))
    assert Y.grad_fn is None and St.grad_fn is None
    Xg = X.clone().requires_grad_(True)
    Y2, St2 = ssd_intra_chunk(Xg, A_cs, _heads(Bm, h), _heads(Cm, h))
    assert type(Y2.grad_fn).__name__ == "SsdIntraChunkFnBackward"
    assert torch.equal(Y2.detach(), Y) and torch.equal(St2.detach(), St)
    (dX,) = torch.autograd.grad((Y2, St2), Xg, (dY, dS))
    want = ref.ssd_intra_chunk_bwd_ref(X, A_cs, _heads(Bm, h), _heads(Cm, h),
                                       dY, dS)[0]
    assert torch.equal(dX, want)


def test_ssd_bwd_checks_its_inputs():
    X, A, Bm, Cm, dY, dS = (torch.as_tensor(a)
                            for a in _ssd_inputs(SSD_CASES[1]))
    with pytest.raises(ValueError, match="want X and dY"):
        ssd_intra_chunk_bwd(X, A, Bm, Cm, dY, dS[..., :2])
