"""Alg. 3 on a d_w-sharded ΔW: ``fed.parallel.edc_embedding_distributed``
(and one ``kmeans_step``) on ``(1, 2)`` and ``(1, 4)`` worlds of gloo
ranks, each holding its d_w block of a 16 × 4,096 ΔW with a decaying
spectrum (``launch.fed_dryrun.decaying_update_matrix``), with the
Householder QR (TSQR on the model axis) and CholeskyQR2, m = 5.

Held against three oracles:
  - the port on one device from the same Ω: labels equal, E within 3e-5
    after matching each column's sign, V's subspace (its projector, from
    the ranks' blocks stacked) within 1e-3;
  - the JAX package's ``repro.fed.parallel.edc_embedding_distributed`` on
    one device, Ω drawn there from its key (``rsvd_sharded``'s draw,
    ``parallel.py:409``): labels equal, E within 3e-5 up to signs;
  - ``edc_cosine``'s partial-sum entry's plain version: summed over
    blocks of d and finished, it equals ``kernels.ref.cosine_block_ref``
    of the whole.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_driver import spawn_world
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.fed import parallel as jfp
from repro_torch.fed import parallel as fp
from repro_torch.kernels import edc_cosine as edc
from repro_torch.kernels.ref import cosine_block_ref, cosine_sums_ref
from repro_torch.launch.fed_dryrun import decaying_update_matrix

N, D, M_GROUPS, SEED = 16, 4096, 5, 3
E_TOL, SUBSPACE_TOL = 3e-5, 1e-3
QRS = ("householder", "cholesky")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    dW = decaying_update_matrix(N, D, "cpu")
    k = min(M_GROUPS + 8, N)
    key = jax.random.PRNGKey(SEED)
    omegas = {"port": torch.randn((N, k), generator=torch.Generator()
                                  .manual_seed(SEED)).numpy(),
              "jax": np.asarray(jax.random.normal(key, (N, k), jnp.float32))}
    d = tmp_path_factory.mktemp("coldstart2d")
    np.savez(d / "inputs.npz", dW=dW.numpy(), m=M_GROUPS,
             **{f"omega/{k}": v for k, v in omegas.items()})
    return d, dW, omegas, key


def _world(inputs, S):
    d = inputs[0] / f"world{S}"
    d.mkdir()
    return spawn_world(S, d, extra=("coldstart", str(inputs[0] /
                                                     "inputs.npz")),
                       suffix=".coldstart", model=S)


@pytest.fixture(scope="module")
def world2(inputs):
    return _world(inputs, 2)


@pytest.fixture(scope="module")
def world4(inputs):
    return _world(inputs, 4)


def _signs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    s = np.sign(np.sum(got * want, axis=0))
    assert np.all(s != 0)
    return s


def _one_device(dW, omega, qr):
    E, V = fp.edc_embedding_distributed(dW, M_GROUPS, omega=torch.as_tensor(
        omega), qr_impl=qr)
    assign, _ = fp.kmeans_step(E, E[:M_GROUPS])
    return E.numpy(), V.numpy(), assign.numpy()


@pytest.mark.parametrize("qr", QRS)
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_matches_one_device(request, inputs, S, qr):
    _, dW, omegas, _ = inputs
    ranks = request.getfixturevalue(f"world{S}")
    E1, V1, a1 = _one_device(dW, omegas["port"], qr)
    tag = f"{qr}/port"
    V = np.concatenate([z[f"{tag}/V"] for z in ranks])    # blocks in order
    assert V.shape == V1.shape
    P, P1 = V @ V.T, V1 @ V1.T
    assert np.abs(P - P1).max() <= SUBSPACE_TOL
    for z in ranks:
        assert np.array_equal(z[f"{tag}/assign"], a1)
        E = z[f"{tag}/E"]
        np.testing.assert_allclose(E * _signs(E, E1), E1, atol=E_TOL)
        # replicated: every rank's E and labels are rank 0's
        assert z[f"{tag}/E"].tobytes() == ranks[0][f"{tag}/E"].tobytes()


@pytest.mark.parametrize("qr", QRS)
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_matches_jax(request, inputs, S, qr):
    _, dW, _, key = inputs
    jE, jV = jfp.edc_embedding_distributed(jnp.asarray(dW.numpy()),
                                           M_GROUPS, key=key, qr_impl=qr)
    jE = np.asarray(jE)
    ja, _ = jfp.kmeans_step(jnp.asarray(jE), jnp.asarray(jE[:M_GROUPS]))
    for z in request.getfixturevalue(f"world{S}"):
        E = z[f"{qr}/jax/E"]
        np.testing.assert_allclose(E * _signs(E, jE), jE, atol=E_TOL)
        assert np.array_equal(z[f"{qr}/jax/assign"], np.asarray(ja))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
def test_partial_entry_summed_over_blocks_is_the_cosine(inputs, blocks,
                                                        dtype):
    _, dW, _, _ = inputs
    V = torch.linalg.qr(torch.randn((D, M_GROUPS), generator=torch
                                    .Generator().manual_seed(1)))[0]
    dW, V = dW.to(dtype), V.to(dtype)
    cuts = [b * D // blocks for b in range(blocks + 1)]
    packed = sum(edc.edc_cosine_partial(dW[:, a:b].contiguous(),
                                        V[a:b].contiguous())
                 for a, b in zip(cuts, cuts[1:]))
    assert packed.shape == (N * M_GROUPS + N + M_GROUPS,)
    np.testing.assert_allclose(
        edc.cosine_from_sums(packed, N, M_GROUPS).numpy(),
        cosine_block_ref(dW, V).numpy(), atol=E_TOL)
    dots, rsq, csq = edc.split_sums(cosine_sums_ref(dW, V), N, M_GROUPS)
    np.testing.assert_allclose(dots.numpy(), (dW.float() @ V.float())
                               .numpy(), rtol=1e-5, atol=1e-5)
    assert edc.partial_launches == 0          # CPU tensors: plain version


def test_partial_entry_on_meta_is_shapes_only():
    out = edc.edc_cosine_partial(torch.empty((64, 1000), device="meta"),
                                 torch.empty((1000, 5), device="meta"))
    assert out.device.type == "meta" and out.shape == (64 * 5 + 64 + 5,)
