"""The synchronous trainers on a data mesh of gloo ranks on the CPU.

Worlds of S = 1, 2 and 4 ranks (``tests/_torch_mesh_driver.py``, one
process a rank, one torch thread each, a FileStore in ``tmp_path``) run
FedAvg, FedGroup with EDC and with MADC, IFCA and FeSEM at the
reference's small fixture (``tests/test_trainer_sharding.py``), per round
and in blocks, pinned; FedGroup and FeSEM streamed through
``ShardedClientStore``; one quarantine run (the cohort median over the
gathered norms), one cohort that neither 2 nor 4 divides (replicated),
FedGroup with the shift detector, and LCFL (a tensor assignment state).

Held: S = 2 and 4 against S = 1 — membership, cold-start founders and
labels equal, weighted accuracy within 2e-3 (the reference's own bound),
mean loss and discrepancy within rtol 1e-4, each group-parameter leaf
within 1e-5 in relative Frobenius norm; every rank's replicas (group
parameters, membership, FeSEM's rows, the streamed host table) equal bit
for bit; a mesh of one equal to ``mesh=None`` bit for bit; a streamed
rank's cohort tensors K / S rows.
"""
import numpy as np
import pytest

from _torch_mesh_driver import K_ODD, SCENARIOS, spawn_world
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ACC_ATOL, RTOL, LEAF_RTOL = 2e-3, 1e-4, 1e-5
K = 8


def _world(tmp_path_factory, S):
    return spawn_world(S, tmp_path_factory.mktemp(f"world{S}"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


def _run(z: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_of_one_equals_no_mesh(world1, name):
    mesh, none = _run(world1[0], name), _run(world1[0], name + "@none")
    assert sorted(mesh) == sorted(none)
    for k in mesh:
        assert mesh[k].shape == none[k].shape, k
        assert np.array_equal(mesh[k], none[k], equal_nan=True), k


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_matches_world_of_one(world1, request, S, name):
    ref = _run(world1[0], name + "@none")
    got = _run(request.getfixturevalue(f"world{S}")[0], name)
    for k in ("membership", "labels", "pre_idx", "table/membership"):
        if k in ref:
            assert np.array_equal(got[k], ref[k]), k
    h, hr = got["hist"], ref["hist"]
    assert h.shape == hr.shape
    np.testing.assert_allclose(h[:, 0], hr[:, 0], atol=ACC_ATOL, rtol=0)
    np.testing.assert_allclose(h[:, 1:3], hr[:, 1:3], rtol=RTOL)
    np.testing.assert_array_equal(h[:, 3], hr[:, 3])       # quarantined
    assert got["comm"][0] == ref["comm"][0]
    assert np.array_equal(got["counters"], ref["counters"])
    if "eval" in ref:
        np.testing.assert_allclose(got["eval"], ref["eval"], atol=ACC_ATOL,
                                   rtol=0)
    leaves = [k for k in ref if k.startswith("gp/")]
    assert leaves
    for k in leaves:
        err = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert err <= LEAF_RTOL, (k, err)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_equal_across_ranks(request, S, name):
    ranks = [_run(z, name) for z in request.getfixturevalue(f"world{S}")]
    for r, z in enumerate(ranks[1:], 1):
        assert sorted(z) == sorted(ranks[0])
        for k in z:
            assert np.array_equal(z[k], ranks[0][k], equal_nan=True), (r, k)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["fedgroup_streamed", "fesem_streamed"])
def test_streamed_rank_stages_its_share(request, S, name):
    """A rank's cohort tensors hold K / S rows (its H2D share); n is whole."""
    rows = _run(request.getfixturevalue(f"world{S}")[0], name)["cohort_rows"]
    assert rows.shape == (2, 2)
    assert (rows[:, 0] == K // S).all() and (rows[:, 1] == K).all()


def test_shift_detector_probes_and_migrates(world2):
    cold, migrated, checks = _run(world2[0], "fedgroup_shift")["counters"]
    assert cold > 0 and migrated > 0 and checks > 0


def test_quarantine_screens_clients_by_the_gathered_median(world1):
    h = _run(world1[0], "fedgroup_quarantine@none")["hist"]
    assert h[:, 3].sum() > 0


def test_odd_cohort_is_replicated(world1, world2, world4):
    """K = 7: no collective in the round, so every world's rounds equal the
    world of one's exactly (the cold start's 4 founders and the eval still
    shard, and their gathers and integer counts are exact)."""
    assert SCENARIOS["fedgroup_odd_cohort"][1]["clients_per_round"] == K_ODD
    ref = _run(world1[0], "fedgroup_odd_cohort@none")
    for world in (world2, world4):
        got = _run(world[0], "fedgroup_odd_cohort")
        for k in ref:
            assert np.array_equal(got[k], ref[k], equal_nan=True), k


def test_blocks_run_eagerly_on_the_cpu(world2):
    """The block scenarios ran blocks; on the CPU a block is ``block_fn``
    run eagerly: no graph replays."""
    for name in SCENARIOS:
        run = _run(world2[0], name)
        assert run["blocks"][0] == name.endswith("_block"), name
        assert run["replays"][0] == 0
