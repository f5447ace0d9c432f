"""The port's ``fed/parallel.py`` (the mesh-free half) and
``launch/fed_dryrun.py`` against ``repro.fed.parallel`` on the same inputs,
at the sizes of ``tests/test_fed_parallel.py`` and
``tests/test_perf_variants.py:112-147``.

The minibatch rows are the reference's, replayed from its client keys;
the randomized SVD's Ω is ``jax.random.normal(key, (n, k))``, the draw
``rsvd_sharded`` makes from its key (``parallel.py:409``).
``repro.launch.fed_dryrun`` forces 512 host devices when imported
(``tests/conftest.py``), so its workloads' shapes are stated here from
``fed_dryrun.py:39-79``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import replay_batch_indices, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.fed import parallel as jfp
from repro.models.paper_models import mclr as jmclr
from repro_torch.convert import params_from_numpy
from repro_torch.fed import parallel as fp
from repro_torch.kernels.edc_cosine import edc_cosine
from repro_torch.kernels.ref import cosine_block_ref
from repro_torch.launch import fed_dryrun
from repro_torch.models.paper_models import mclr

ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
SVD_TOL = 1e-4

# fed_dryrun.py:39-58 (run_round) and :61-74 (run_coldstart): the
# reference's argument shapes at its defaults
REF_ROUND_SHAPES = [(5, 512), (5, 62), (5, 784, 512), (5, 512, 62),
                    (1024,), (1024, 256, 784), (1024, 256), (1024,)]
REF_ROUND_KEYS = (1024, 2)
REF_COLDSTART_SHAPES = [(64, 415_258_624)]
REF_COLDSTART_KEY = (2,)


def _round_setup(K=8, max_n=20, dim=6, m=3):
    """tests/test_fed_parallel.py's TestParallelRound._setup."""
    key = jax.random.PRNGKey(0)
    model = jmclr(dim, 4)
    params = model.init(key)
    gp = jax.tree_util.tree_map(
        lambda l: jnp.stack([l + 0.01 * i for i in range(m)]), params)
    ks = jax.random.split(key, 5)
    X = jax.random.normal(ks[0], (K, max_n, dim))
    Y = jax.random.randint(ks[1], (K, max_n), 0, 4)
    n = jnp.full((K,), max_n, jnp.int32).at[1].set(7)
    membership = jnp.asarray([i % m for i in range(K)])
    keys = jax.random.split(ks[2], K)
    return gp, membership, X, Y, n, keys, m, dim


@pytest.mark.parametrize("epochs,mu,lr", [(2, 0.0, 0.05), (3, 1.0, 0.1)])
def test_parallel_round_matches_reference(epochs, mu, lr):
    gp, mem, X, Y, n, keys, m, dim = _round_setup()
    kw = dict(epochs=epochs, batch_size=5, lr=lr, mu=mu, n_groups=m,
              max_samples=20)
    jout = jax.jit(jfp.make_parallel_round(jmclr(dim, 4), **kw))(
        gp, mem, X, Y, n, keys)
    rf = fp.make_parallel_round(mclr(dim, 4), **kw)
    tout = rf(params_from_numpy(jax.tree_util.tree_map(np.asarray, gp)),
              torch.as_tensor(np.array(mem)), torch.as_tensor(np.array(X)),
              torch.as_tensor(np.array(Y)), torch.as_tensor(np.array(n)),
              replay_batch_indices(keys, np.asarray(n), rf.max_steps, 5))
    assert len(tout) == 3
    for t, j in zip(tout, jout):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_allclose(tnp(t[k]), np.asarray(j[k]),
                                       **ROUND_TOL)


def test_cholesky_qr2_matches_reference():
    Y = jax.random.normal(jax.random.PRNGKey(6), (500, 12))
    jQ, jR = jfp.cholesky_qr2(Y)
    tQ, tR = fp.cholesky_qr2(torch.as_tensor(np.array(Y)))
    np.testing.assert_allclose(tnp(tQ), np.asarray(jQ), atol=1e-5)
    np.testing.assert_allclose(tnp(tR), np.asarray(jR), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tnp(tQ.T @ tQ), np.eye(12), atol=1e-5)


def _decaying_dW():
    """tests/test_perf_variants.py:121-127: a (20, 300) ΔW with a decaying
    spectrum."""
    key = jax.random.PRNGKey(7)
    U = jnp.linalg.qr(jax.random.normal(key, (300, 20)))[0]
    s = 10.0 * 0.8 ** jnp.arange(20)
    return ((U * s) @ jax.random.normal(jax.random.fold_in(key, 1),
                                        (20, 20))).T


def _gaussian_dW():
    """tests/test_fed_parallel.py's cold start: ΔW (16, 400) standard
    normal."""
    return jax.random.normal(jax.random.PRNGKey(8), (16, 400))


def _omega(key, n, m):
    return jax.random.normal(key, (n, min(m + 8, n)), jnp.float32)


def _same_up_to_sign(got: np.ndarray, want: np.ndarray, tol: float):
    sign = np.sign(np.sum(got * want, axis=0))
    assert np.all(sign != 0)
    np.testing.assert_allclose(got * sign, want, atol=tol)


CASES = [("decaying", _decaying_dW, 4, 7), ("gaussian", _gaussian_dW, 3, 8)]


@pytest.mark.parametrize("qr_impl", ["householder", "cholesky"])
@pytest.mark.parametrize("name,make,m,seed", CASES)
def test_rsvd_sharded_matches_reference(name, make, m, seed, qr_impl):
    dW = make()
    key = jax.random.PRNGKey(seed)
    jV = jfp.rsvd_sharded(dW, m, key=key, qr_impl=qr_impl)
    tV = fp.rsvd_sharded(torch.as_tensor(np.array(dW)), m,
                         omega=torch.as_tensor(np.array(
                             _omega(key, dW.shape[0], m))), qr_impl=qr_impl)
    assert tuple(tV.shape) == tuple(jV.shape)
    _same_up_to_sign(tnp(tV), np.asarray(jV), SVD_TOL)


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("qr_impl", ["householder", "cholesky"])
@pytest.mark.parametrize("name,make,m,seed", CASES)
def test_edc_embedding_distributed_matches_reference(name, make, m, seed,
                                                     qr_impl, ref_kernel):
    """E (and V) up to each column's sign, against both of the reference's
    paths: its plain cosine and (``ref_kernel``) its Pallas kernel in
    interpret mode. The port has one path: ``edc_cosine``, whose plain
    version runs on the CPU."""
    dW = make()
    key = jax.random.PRNGKey(seed)
    jE, jV = jfp.edc_embedding_distributed(dW, m, key=key, qr_impl=qr_impl,
                                           use_kernel=ref_kernel)
    tE, tV = fp.edc_embedding_distributed(
        torch.as_tensor(np.array(dW)), m,
        omega=torch.as_tensor(np.array(_omega(key, dW.shape[0], m))),
        qr_impl=qr_impl)
    _same_up_to_sign(tnp(tV), np.asarray(jV), SVD_TOL)
    sign = np.sign(np.sum(tnp(tV) * np.asarray(jV), axis=0))
    np.testing.assert_allclose(tnp(tE) * sign, np.asarray(jE), atol=SVD_TOL)


def test_edc_embedding_is_edc_cosine_of_dw_and_v():
    """E is the cosine block of ΔW and the returned V, as
    ``kernels.ref.cosine_block_ref`` computes it."""
    dW = torch.as_tensor(np.array(_gaussian_dW()))
    om = torch.as_tensor(np.array(_omega(jax.random.PRNGKey(8), 16, 3)))
    E, V = fp.edc_embedding_distributed(dW, 3, omega=om)
    np.testing.assert_allclose(tnp(E), tnp(cosine_block_ref(dW, V)),
                               atol=1e-6)


def test_rsvd_refuses_a_wrong_omega_or_qr():
    dW = torch.zeros((6, 30))
    with pytest.raises(ValueError, match="omega"):
        fp.rsvd_sharded(dW, 2, omega=torch.zeros((6, 5)))
    with pytest.raises(ValueError, match="qr_impl"):
        fp.rsvd_sharded(dW, 2, omega=torch.zeros((6, 6)), qr_impl="tsqr")


def _blobs():
    key = jax.random.PRNGKey(1)
    return jnp.concatenate([
        jax.random.normal(key, (10, 3)) + 4,
        jax.random.normal(jax.random.fold_in(key, 1), (10, 3)) - 4])


@pytest.mark.parametrize("centers_rows", [[0, 1], [0, 12], [0, 1, 2, 3]])
def test_kmeans_step_matches_reference(centers_rows):
    """Five Lloyd steps from the given rows (two from one blob: a cluster
    that empties keeps its center)."""
    E = _blobs()
    jc = E[jnp.asarray(centers_rows)]
    tE = torch.as_tensor(np.array(E))
    tc = torch.as_tensor(np.array(jc))
    for _ in range(5):
        ja, jc = jfp.kmeans_step(E, jc)
        ta, tc = fp.kmeans_step(tE, tc)
        assert np.array_equal(tnp(ta), np.asarray(ja))
        np.testing.assert_allclose(tnp(tc), np.asarray(jc), atol=1e-6)


def test_full_coldstart_pipeline_recovers_clusters():
    """tests/test_fed_parallel.py's pipeline, port only: three directions
    plus noise, CQR2, ten Lloyd steps: each true cluster one label."""
    key = jax.random.PRNGKey(2)
    dirs = jax.random.normal(key, (3, 500))
    dW = jnp.concatenate([
        dirs[i] + 0.05 * jax.random.normal(jax.random.fold_in(key, i),
                                           (8, 500)) for i in range(3)])
    E, _ = fp.edc_embedding_distributed(
        torch.as_tensor(np.array(dW)), 3,
        omega=torch.as_tensor(np.array(_omega(key, 24, 3))),
        qr_impl="cholesky")
    centers = E[torch.tensor([0, 8, 16])]
    for _ in range(10):
        assign, centers = fp.kmeans_step(E, centers)
    a = tnp(assign)
    assert len({tuple(np.unique(a[g * 8:(g + 1) * 8])) for g in range(3)}) \
        == 3
    assert all(len(np.unique(a[g * 8:(g + 1) * 8])) == 1 for g in range(3))


def test_edc_cosine_on_meta_is_shapes_only():
    E = edc_cosine(torch.empty((64, 1_000_000), device="meta"),
                   torch.empty((1_000_000, 5), device="meta"))
    assert E.is_meta and tuple(E.shape) == (64, 5)
    assert E.dtype == torch.float32


def test_run_round_on_meta_at_the_reference_size():
    fn, args = fed_dryrun.run_round()
    gp, *rest, idx = args
    shapes = [tuple(gp[k].shape) for k in sorted(gp)] + \
        [tuple(t.shape) for t in rest]
    assert shapes == REF_ROUND_SHAPES
    # the reference's (K, 2) client keys are the port's minibatch rows
    assert tuple(idx.shape) == (REF_ROUND_KEYS[0], 20 * 26, 10)
    assert all(t.is_meta for t in [*gp.values(), *rest, idx])
    rec = fed_dryrun.record("round", fn, args, qr="householder")
    assert rec["status"] == "ok" and rec["mesh"] == "1"
    assert rec["argument_shapes"][:8] == [list(s) for s in REF_ROUND_SHAPES]
    assert rec["cost_analysis"]["flops"] > 0
    # 5 group models, 5 group deltas and the global model of mlp(784, 512,
    # 62): 433,726 params
    assert rec["memory_analysis"]["output_size_in_bytes"] == \
        4 * 433_726 * (5 + 5 + 1)


@pytest.mark.parametrize("qr_impl", ["householder", "cholesky"])
def test_run_coldstart_on_meta_at_the_reference_size(qr_impl):
    fn, args = fed_dryrun.run_coldstart(qr_impl=qr_impl)
    dW, omega = args
    assert [tuple(dW.shape)] == REF_COLDSTART_SHAPES
    # the reference's PRNG key is the port's Ω (64, m + 8)
    assert tuple(omega.shape) == (64, 13)
    rec = fed_dryrun.record("coldstart", fn, args, qr=qr_impl)
    assert rec["status"] == "ok"
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        4 * 64 * (415_258_624 + 13)
    assert rec["cost_analysis"]["flops_by_op"]["aten.mm"] > 0


def test_run_round_small_on_the_cpu_is_finite():
    fn, args = fed_dryrun.run_round("cpu", n_clients=6, max_n=12, dim=20,
                                    n_groups=2, epochs=1, batch=4)
    groups, glob, delta = fn(*args)
    for t in (*groups.values(), *glob.values(), *delta.values()):
        assert torch.isfinite(t).all()
    fn2, args2 = fed_dryrun.run_round("cpu", n_clients=6, max_n=12, dim=20,
                                      n_groups=2, epochs=1, batch=4)
    assert all(torch.equal(a, b) for a, b in zip(args[1:], args2[1:]))


def test_run_coldstart_small_on_the_cpu_finds_the_spectrum():
    fn, (dW, omega) = fed_dryrun.run_coldstart("cpu", n_pre=16, d_w=4096,
                                               m=3)
    s = torch.linalg.svdvals(dW)
    assert s[4] > 5 * s[5]                       # the m leading, then a gap
    assign, centers, E = fn(dW, omega)
    assert tuple(E.shape) == (16, 3) and torch.isfinite(E).all()
    assert int(assign.max()) < 3


def test_multi_pod_raises_without_a_mesh():
    """Ported (16c): ``fed_dryrun --multi-pod`` runs on the 2 × 16 × 16
    mesh (``tests/test_torch_mesh2d_dryrun.py``) and is refused only
    without a mesh. The zoo's dry run takes ``--multi-pod`` too (16d-i,
    ``tests/test_torch_zoo_dryrun_mesh.py``), refused likewise without a
    mesh, and so are the flags that shard a train state (16d-ii)."""
    with pytest.raises(SystemExit):
        fed_dryrun.main(["--mesh", "1", "--multi-pod"])
    from repro_torch.launch import dryrun
    dryrun.check_flags("production", multi_pod=True, zero=True)
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "1", "--multi-pod", "--all"])
    with pytest.raises(ValueError, match="--zero"):
        dryrun.check_flags("1", multi_pod=False, zero=True)