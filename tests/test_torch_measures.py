"""The port's measures, SVD, clustering and kernel plain versions against
the JAX package on the CPU. Tolerances: single ops in fp32 1e-5; the
kernels' plain versions against the Pallas kernels (interpret mode) 3e-5,
the tolerance of tests/test_kernels.py; the SVD-based embedding 1e-4
(QR and SVD run through two LAPACK call sequences)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pp_seed_indices_jax, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import cluster as jcluster
from repro.core import measures as jmeas
from repro.core import svd as jsvd
from repro.kernels.edc_cosine import edc_cosine as j_edc_cosine
from repro.kernels.madc import madc_block as j_madc_block
from repro.kernels import ref as jref
from repro_torch.core import cluster as tcluster
from repro_torch.core import measures as tmeas
from repro_torch.core import svd as tsvd
from repro_torch.draws import TorchDraws
from repro_torch.kernels import edc_cosine as tedc
from repro_torch.kernels import ops, ref

OP_TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=3e-5, rtol=3e-5)
SVD_TOL = dict(atol=1e-4, rtol=1e-4)


def _dw(n, d, seed=0, groups=3):
    """Clustered client updates: a few shared directions plus noise."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(groups, d))
    lab = rng.integers(0, groups, n)
    return (dirs[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def test_cosine_similarity_matrix_matches():
    a, b = _dw(9, 40, 0), _dw(4, 40, 1)
    np.testing.assert_allclose(
        tnp(tmeas.cosine_similarity_matrix(torch.as_tensor(a))),
        np.asarray(jmeas.cosine_similarity_matrix(jnp.asarray(a))), **OP_TOL)
    np.testing.assert_allclose(
        tnp(tmeas.cosine_similarity_matrix(torch.as_tensor(a),
                                           torch.as_tensor(b))),
        np.asarray(jmeas.cosine_similarity_matrix(jnp.asarray(a),
                                                  jnp.asarray(b))), **OP_TOL)


@pytest.mark.parametrize("n", [3, 7, 60, 130])
def test_madc_plain_matches_reference_and_pallas_kernel(n):
    M = np.array(jmeas.cosine_similarity_matrix(jnp.asarray(_dw(n, 32, n))))
    before = ops.launch_counts()
    got = tnp(tmeas.madc(torch.as_tensor(M)))
    assert ops.launch_counts() == before       # a CPU tensor: plain version
    np.testing.assert_allclose(got, np.asarray(jmeas.madc(jnp.asarray(M))),
                               **OP_TOL)
    np.testing.assert_allclose(
        got, np.asarray(j_madc_block(jnp.asarray(M), interpret=True)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        tnp(ref.madc_ref(torch.as_tensor(M))), got, **OP_TOL)


@pytest.mark.parametrize("n,d,m,dtype", [
    (60, 785, 3, "float32"),
    (7, 129, 2, "float32"),
    (33, 4097, 11, "float32"),
    (1, 64, 1, "float32"),
    (32, 1024, 4, "bfloat16"),
])
def test_edc_cosine_plain_matches_pallas_kernel(n, d, m, dtype):
    rng = np.random.default_rng(n * 7 + d)
    dW = rng.normal(size=(n, d)).astype(np.float32)
    V = rng.normal(size=(d, m)).astype(np.float32)
    jd, jv = jnp.asarray(dW, dtype), jnp.asarray(V, dtype)
    td = torch.as_tensor(dW).to(getattr(torch, dtype))
    tv = torch.as_tensor(V).to(getattr(torch, dtype))
    got = tnp(tedc.edc_cosine(td, tv))
    np.testing.assert_allclose(got, np.asarray(j_edc_cosine(
        jd, jv, interpret=True)), **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.cosine_block_ref(jd, jv)), **KERNEL_TOL)


def test_edc_cosine_plain_keeps_both_eps_clamps():
    dW = torch.tensor([[1.0, 2.0], [0.0, 0.0]])
    V = torch.tensor([[1.0, 0.0], [0.0, 0.0]])        # column 1 is zero
    got = ref.cosine_block_ref(dW, V)
    want = j_edc_cosine(jnp.asarray(dW.numpy()), jnp.asarray(V.numpy()),
                        interpret=True)
    np.testing.assert_allclose(tnp(got), np.asarray(want), **KERNEL_TOL)
    assert torch.isfinite(got).all()


def test_randomized_svd_same_omega_same_subspace():
    A = _dw(12, 300, 3).T                          # (d, n)
    m, k = 3, min(3 + 8, 12)
    key = jax.random.PRNGKey(4)
    omega = np.array(jax.random.normal(key, (12, k), jnp.float32))
    jV = np.asarray(jsvd.randomized_truncated_svd(jnp.asarray(A), m,
                                                  key=key))
    tV = tnp(tsvd.randomized_truncated_svd(torch.as_tensor(A), m,
                                           omega=torch.as_tensor(omega)))
    # singular vectors are unique up to sign: compare |V| and projectors
    np.testing.assert_allclose(np.abs(tV), np.abs(jV), **SVD_TOL)
    np.testing.assert_allclose(tV @ tV.T, jV @ jV.T, **SVD_TOL)
    np.testing.assert_allclose(tV.T @ tV, np.eye(m), atol=1e-5)


def test_edc_embed_same_omega_same_distances():
    dW = _dw(15, 200, 5)
    m = 3
    key = jax.random.PRNGKey(7)
    omega = np.array(jax.random.normal(key, (15, min(m + 8, 15)),
                                       jnp.float32))
    jE, _ = jmeas.edc_embed(jnp.asarray(dW), m, key=key)
    tE, _ = tmeas.edc_embed(torch.as_tensor(dW), m,
                            omega=torch.as_tensor(omega))
    # column signs may differ between the QR/SVD implementations; EDC
    # distances and |E| do not depend on them
    np.testing.assert_allclose(np.abs(tnp(tE)), np.abs(np.asarray(jE)),
                               **SVD_TOL)
    np.testing.assert_allclose(
        tnp(tmeas.edc_from_embedding(tE, m)),
        np.asarray(jmeas.edc_from_embedding(jE, m)), **SVD_TOL)
    np.testing.assert_allclose(
        tnp(tmeas.edc_from_embedding(torch.as_tensor(np.asarray(jE)), m)),
        np.asarray(jmeas.edc_from_embedding(jE, m)), **OP_TOL)


def test_cosine_dissimilarity_matches():
    a, b = _dw(2, 50, 8)
    np.testing.assert_allclose(
        float(tmeas.cosine_dissimilarity(torch.as_tensor(a),
                                         torch.as_tensor(b))),
        float(jmeas.cosine_dissimilarity(jnp.asarray(a), jnp.asarray(b))),
        **OP_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_pp_same_seeds_same_clusters(seed):
    X = _dw(40, 4, seed, groups=4)
    key = jax.random.PRNGKey(seed)
    seeds = pp_seed_indices_jax(key, X, 4)
    # the replayed indices are the reference seeding's own centres
    np.testing.assert_array_equal(
        X[tnp(seeds)], np.asarray(jcluster._pp_seed(key, jnp.asarray(X), 4)))
    ja, jc = jcluster.kmeans_pp(key, jnp.asarray(X), 4)
    ta, tc = tcluster.kmeans_pp(torch.as_tensor(X), 4, seed_idx=seeds)
    assert np.array_equal(tnp(ta), np.asarray(ja))
    np.testing.assert_allclose(tnp(tc), np.asarray(jc), **OP_TOL)
    np.testing.assert_allclose(
        float(tcluster.kmeans_inertia(torch.as_tensor(X), ta, tc)),
        float(jcluster.kmeans_inertia(jnp.asarray(X), ja, jc)), **OP_TOL)


def test_kmeans_pp_own_draws_are_seeded():
    X = torch.as_tensor(_dw(30, 3, 9))
    sa, sb = TorchDraws(0).kmeans_seeds(X, 3), TorchDraws(0).kmeans_seeds(X, 3)
    assert torch.equal(sa, sb)
    a = tcluster.kmeans_pp(X, 3, sa)
    b = tcluster.kmeans_pp(X, 3, sb)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    zeros = tcluster.pp_seed_indices(torch.zeros(5, 2), 3,
                                     torch.Generator().manual_seed(0))
    assert zeros.shape == (3,)                 # all-zero d2 draws uniformly


@pytest.mark.parametrize("n,k", [(20, 3), (41, 5), (6, 6)])
def test_hierarchical_labels_equal_reference(n, k):
    M = np.asarray(jmeas.cosine_similarity_matrix(jnp.asarray(_dw(n, 30, n))))
    P = np.asarray(jmeas.madc(jnp.asarray(M)))
    assert np.array_equal(tcluster.hierarchical(P, k),
                          jcluster.hierarchical(P, k))
