"""The backward routes on the CPU: what ``swa_attention_bwd`` and
``ssd_intra_chunk_bwd`` decide in Python, the plain versions the card's
kernels are held to, and the grouped B/C layout of the SSD block, each on
inputs made from a seed with numpy and fed to the JAX function and the
port alike.

- ``swa_attention._bwd_route``: ``tc`` for bf16 q and k/v at every head dim
  up to 256 (40, 56, 64, 80, 128, 256), ``fp32`` for fp32 or mixed.
- ``ref.swa_attention_bwd_ref(..., rounded=True)``, the ``tc`` route's
  plain version (dO, P, dS rounded to bf16), within 2e-2 of each gradient's
  largest magnitude of the fp32 plain version and of ``jax.vjp`` of
  ``repro.kernels.ref.swa_attention_ref`` (``chip_smoke.py``'s
  ``TRAIN_TOL["bfloat16"]``: rounding P and dS to bf16 moves a gradient by
  ~2^-8 of its scale).
- ``ssd_intra_chunk`` with B and C by group (g = 1 and g = 2 against h = 4)
  equal to the same call on the head-expanded tensors, forward (exactly:
  the plain version expands them itself) and backward (each group's dB, dC
  the sum of its heads' within 1e-6: the same fp32 sums in another order);
  the group gradients through ``models.ssm.ssd_chunked`` against
  ``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` on the expanded tensors,
  summed over each group's heads, within 1e-4 (the SSD ``jax.vjp``
  tolerance of ``tests/test_torch_train_kernels.py``: dA_cs is a difference
  of sums that cancel).
- the kernel's decomposition by group, emulated in torch (dC = (Σ_h W_h) B,
  dB = (Σ_h W_h)ᵀ C + Σ_h decay_h ⊙ X_h dS_h) against the plain version
  within 1e-5; ``ssd_bwd_heads_per_cta``.
- ``mamba2_fwd``'s parameter gradients (n_groups 1 and 2) against
  ``jax.grad`` of the JAX package's ``mamba2_fwd`` within 2e-5 of each
  leaf's largest (the hybrid train tests' gradient tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels import swa_attention as swa_mod
from repro_torch.models import ssm as tssm

BF, F32 = torch.bfloat16, torch.float32


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# swa_attention_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [40, 56, 64, 80, 128, 256])
@pytest.mark.parametrize("dq,dkv,want", [(BF, BF, "tc"), (F32, F32, "fp32"),
                                         (F32, BF, "fp32"),
                                         (BF, F32, "fp32")],
                         ids=["bf16", "fp32", "fp32-q", "fp32-kv"])
def test_bwd_route(hd, dq, dkv, want):
    assert swa_mod._bwd_route(dq, dkv, hd) == want


def test_bwd_route_takes_no_head_dim_past_the_kernels():
    assert swa_mod._bwd_route(BF, BF, 257) == "fp32"
    assert swa_mod.MAX_HEAD_DIM == 256


# (B, Sq, Sk, H, KV, hd, window, causal)
SWA_CASES = [(1, 24, 24, 4, 4, 64, None, True),
             (1, 10, 19, 4, 1, 56, 6, True),
             (2, 9, 9, 2, 1, 80, None, False)]


def _swa_np(case, seed):
    B, Sq, Sk, H, KV, hd, _, _ = case
    rng = np.random.default_rng(seed)
    # bf16 values, so the JAX function and the port see the same inputs
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               .to(BF).float().numpy()
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    do = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", SWA_CASES, ids=["mha", "mqa-window-sq<sk",
                                                 "bidir-hd80"])
def test_rounded_swa_bwd_ref_within_bf16_tolerance(case):
    B, Sq, Sk, H, KV, hd, window, causal = case
    q, k, v, do = _swa_np(case, seed=4)

    def f(q, k, v):
        return jref.swa_attention_ref(q, jnp.repeat(k, H // KV, axis=2),
                                      jnp.repeat(v, H // KV, axis=2),
                                      window=window, causal=causal)
    o, vjp = jax.vjp(f, q, k, v)
    want_jax = vjp(do)
    qt, kt, vt = (torch.as_tensor(a).to(BF) for a in (q, k, v))
    ot, dot = torch.as_tensor(np.array(o)), torch.as_tensor(do)
    got = ref.swa_attention_bwd_ref(qt, kt, vt, ot, dot, window=window,
                                    causal=causal, rounded=True)
    plain = ref.swa_attention_bwd_ref(qt, kt, vt, ot, dot, window=window,
                                      causal=causal)
    for g, p, w in zip(got, plain, want_jax):
        assert g.dtype == torch.float32
        assert rel_err(g, p) <= 2e-2 and rel_err(g, w) <= 2e-2
        assert rel_err(p, w) <= 1e-5
    # the rounding is really there: P and dS in bf16 move the gradients
    assert max(rel_err(g, p) for g, p in zip(got, plain)) > 1e-5


def test_rounded_swa_bwd_ref_rounds_do_p_and_ds():
    """``rounded`` is the fp32 plain version with dO rounded to bf16 first
    and P, dS rounded before their products, step by step."""
    case = SWA_CASES[0]
    q, k, v, do = (torch.as_tensor(a) for a in _swa_np(case, seed=5))
    o = ref.swa_attention_ref(q, k, v, window=None)
    scale = 1.0 / 64 ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(ref._swa_kept(24, 24, None, True, "cpu"), s, -1e30)
    p = torch.softmax(s, -1)
    dob = do.to(BF).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dob, v)
    d_row = torch.sum(dob * o, -1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - d_row)).to(BF).float()
    want_dv = torch.einsum("bhqk,bqhd->bkhd", p.to(BF).float(), dob)
    want_dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dq, _, dv = ref.swa_attention_bwd_ref(q, k, v, o, do, window=None,
                                          rounded=True)
    torch.testing.assert_close(dv, want_dv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dq, want_dq, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# ssd_intra_chunk with B and C by group
# ---------------------------------------------------------------------------

def _ssd_np(b, c, Q, h, p, n, g, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, c, Q, h, p)).astype(np.float32)
    A = (-rng.uniform(size=(b, h, c, Q)) * scale).astype(np.float32)
    Bg, Cg = (rng.normal(size=(b, c, Q, g, n)).astype(np.float32)
              for _ in range(2))
    dY = rng.normal(size=(b, c, Q, h, p)).astype(np.float32)
    dS = rng.normal(size=(b, c, h, p, n)).astype(np.float32)
    return X, A, Bg, Cg, dY, dS


def _expand(t, h):
    """(…, g, n) by group -> (…, h, n) by head: head j reads j // (h/g)."""
    return np.repeat(t, h // t.shape[-2], axis=-2)


@pytest.mark.parametrize("g", [1, 2], ids=["g1", "g2"])
def test_grouped_ssd_equals_the_head_expanded_call(g):
    b, c, Q, h, p, n = 2, 2, 8, 4, 4, 5
    X, A, Bg, Cg, dY, dS = _ssd_np(b, c, Q, h, p, n, g, seed=6)
    A_cs = torch.cumsum(torch.as_tensor(A), -1)
    tX, tdY, tdS = (torch.as_tensor(a) for a in (X, dY, dS))
    tB, tC = torch.as_tensor(Bg), torch.as_tensor(Cg)
    tBh, tCh = (torch.as_tensor(_expand(a, h)) for a in (Bg, Cg))
    Y, S = ssd_mod.ssd_intra_chunk(tX, A_cs, tB, tC)
    Yh, Sh = ssd_mod.ssd_intra_chunk(tX, A_cs, tBh, tCh)
    assert torch.equal(Y, Yh) and torch.equal(S, Sh)
    got = ssd_mod.ssd_intra_chunk_bwd(tX, A_cs, tB, tC, tdY, tdS)
    per_head = ssd_mod.ssd_intra_chunk_bwd(tX, A_cs, tBh, tCh, tdY, tdS)
    assert got[2].shape == (b, c, Q, g, n) and got[3].shape == got[2].shape
    assert per_head[2].shape == (b, c, Q, h, n)
    assert torch.equal(got[0], per_head[0]) and torch.equal(got[1],
                                                            per_head[1])
    for d, dh in zip(got[2:], per_head[2:]):
        want = dh.reshape(b, c, Q, g, h // g, n).sum(4)
        torch.testing.assert_close(d, want, atol=1e-6, rtol=1e-6)
    # through autograd: the Function's backward returns the group's
    leaves = [t.clone().requires_grad_(True) for t in (tX, A_cs, tB, tC)]
    Y2, S2 = ssd_mod.ssd_intra_chunk(*leaves)
    grads = torch.autograd.grad((Y2, S2), leaves, (tdY, tdS))
    for a, w in zip(grads, got):
        assert torch.equal(a, w)


def test_grouped_ssd_refuses_groups_that_do_not_divide_the_heads():
    X, A, Bg, Cg, dY, dS = _ssd_np(1, 1, 4, 4, 2, 3, 3, seed=7)
    A_cs = torch.cumsum(torch.as_tensor(A), -1)
    args = [torch.as_tensor(a) for a in (X,)] + [A_cs] + [
        torch.as_tensor(a) for a in (Bg, Cg)]
    with pytest.raises(ValueError, match="g dividing h"):
        ssd_mod.ssd_intra_chunk(*args)
    with pytest.raises(ValueError, match="g dividing h"):
        ssd_mod.ssd_intra_chunk_bwd(*args, torch.as_tensor(dY),
                                    torch.as_tensor(dS))


@pytest.mark.parametrize("g", [1, 2, 4], ids=["g1", "g2", "per-head"])
def test_ssd_chunked_group_grads_match_jax_vjp(g):
    b, l, h, p, n, chunk = 2, 16, 4, 4, 6, 8
    rng = np.random.default_rng(8)
    X = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dtA = (-rng.uniform(size=(b, l, h)) * 0.2).astype(np.float32)
    Bg, Cg = (rng.normal(size=(b, l, g, n)).astype(np.float32)
              for _ in range(2))
    dYo = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dF = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def f(X, dtA, Bh, Ch):
        return jssm.ssd_chunked(X, dtA, Bh, Ch, chunk)
    _, vjp = jax.vjp(f, X, dtA, _expand(Bg, h), _expand(Cg, h))
    jX, jA, jB, jC = vjp((dYo, dF))
    jB, jC = (np.asarray(t).reshape(b, l, g, h // g, n).sum(3)
              for t in (jB, jC))
    leaves = [torch.as_tensor(a).requires_grad_(True)
              for a in (X, dtA, Bg, Cg)]
    Y, F_ = tssm.ssd_chunked(*leaves, chunk)
    got = torch.autograd.grad((Y, F_), leaves, (torch.as_tensor(dYo),
                                                torch.as_tensor(dF)))
    for t, w in zip(got, (jX, jA, jB, jC)):
        assert t.shape == np.shape(w)
        assert rel_err(t.numpy(), w) <= 1e-4


def _ssd_bwd_by_group(X, A_cs, Bg, Cg, dY, dS):
    """The kernel's decomposition of dB and dC by group: W_h summed over
    each group's heads first, then one product each; the state's term of
    dB summed over the heads in order."""
    b, c, Q, h, p = X.shape
    g = Bg.shape[3]
    r = h // g
    L, tril = ref._ssd_L(A_cs)                            # (b,h,c,Q,Q)
    Bh, Ch = (t.repeat_interleave(r, dim=3) for t in (Bg, Cg))
    dM = torch.where(tril, torch.einsum("bcihp,bcjhp->bhcij", dY, X), 0.0)
    W = (dM * L).reshape(b, g, r, c, Q, Q).sum(2)         # (b,g,c,i,j)
    dC = torch.einsum("bgcij,bcjgn->bcign", W, Bg)
    decay = torch.exp(A_cs[..., -1:] - A_cs)              # (b,h,c,Q)
    state = torch.einsum("bhck,bckhp,bchpn->bckhn", decay, X, dS)
    dB = (torch.einsum("bgcij,bcign->bcjgn", W, Cg)
          + state.reshape(b, c, Q, g, r, -1).sum(4))
    del Bh, Ch
    return dB, dC


@pytest.mark.parametrize("g", [1, 2], ids=["g1", "g2"])
def test_ssd_bwd_group_decomposition_matches_plain(g):
    X, A, Bg, Cg, dY, dS = (torch.as_tensor(a) for a in _ssd_np(
        2, 3, 16, 4, 8, 6, g, seed=9))
    A_cs = torch.cumsum(A, -1)
    want = ref.ssd_intra_chunk_bwd_ref(X, A_cs, Bg, Cg, dY, dS)
    got = _ssd_bwd_by_group(X, A_cs, Bg, Cg, dY, dS)
    for t, w in zip(got, want[2:]):
        assert rel_err(t, w) <= 1e-5


@pytest.mark.parametrize("b,c,g,rep,n_sm,want", [
    (4, 16, 1, 64, 132, 16),      # Zamba2's training shape: 256 CTAs
    (1, 1, 1, 64, 132, 1),        # too few cells: one head a CTA
    (2, 4, 2, 8, 16, 8),          # a whole group fits
    (4, 16, 8, 8, 1024, 4),       # stops where the grid would shrink
    (3, 5, 4, 1, 132, 1)],        # one head a group
    ids=["zamba2", "small", "whole-group", "g8", "per-head"])
def test_ssd_bwd_heads_per_cta(b, c, g, rep, n_sm, want):
    hb = ssd_mod.ssd_bwd_heads_per_cta(b, c, g, rep, n_sm)
    assert hb == want and rep % hb == 0


# ---------------------------------------------------------------------------
# mamba2_fwd, B and C by group into the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_param_grads_match_jax(n_groups):
    D, S, B_ = 32, 16, 2
    kw = dict(d_state=8, expand=2, head_dim=8, n_groups=n_groups)
    jp = jssm.init_mamba2(jax.random.PRNGKey(1), D, **kw)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B_, S, D)).astype(np.float32)
    R = rng.normal(size=(B_, S, D)).astype(np.float32)

    def loss(params):
        return jnp.sum(jssm.mamba2_fwd(params, x, chunk=8, **kw) * R)
    want = jax.grad(loss)(jp)
    tp = jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.array(a)).requires_grad_(True), jp)
    out = tssm.mamba2_fwd(tp, torch.as_tensor(x), chunk=8, **kw)
    leaves, wleaves = jax.tree_util.tree_leaves(tp), \
        jax.tree_util.tree_leaves(want)
    got = torch.autograd.grad(torch.sum(out * torch.as_tensor(R)), leaves)
    for t, w in zip(got, wleaves):
        assert rel_err(t.numpy(), w) <= 2e-5
