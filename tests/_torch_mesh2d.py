"""Shared helpers of the 2-D ``(data, model)`` mesh tests
(``tests/test_torch_mesh2d_*.py``): the world-of-one reference of every
``_torch_mesh_driver.SCENARIOS`` scenario run in this process
(``mesh=None``, which a mesh of one equals bit for bit:
``tests/test_torch_mesh_trainers.py``), and the checks a rank of a
``(D, M)`` world is held to against it.

A rank r sits at data slice r // M and model index r % M. Its stored
group and global parameters are its blocks of
``sharding.specs.group_param_pspec``, its cached pre-training directions
its block of the d_w columns (``FedMesh.model_cols``); everything else it
keeps whole. The runtime services' scenarios
(``_torch_mesh_driver.SERVICES``) are held the same way against their
runs of one made here (``service_references``).
"""
import numpy as np

from _torch_mesh_driver import fixture, run_scenario, SCENARIOS
from repro_torch.sharding.specs import model_dim

# the 1-D mesh tests' tolerances (tests/_torch_mesh_driver.py)
ACC_ATOL, RTOL, LEAF_RTOL = 2e-3, 1e-4, 1e-5
K = 8
WHOLE = ("group_delta", "local_flat", "table/local_flat")
# kept as a model index's block of the d_w columns
COLS = ("table/dirs",)
EXACT = ("membership", "labels", "pre_idx", "counters", "comm",
         "table/membership", "table/has_dir", "blocks", "replays")


def reference_runs(names=None) -> dict:
    """{scenario: its arrays} on one device (``mesh=None``), for ``names``
    (all of ``SCENARIOS`` by default)."""
    data, model = fixture()
    return {name: run_scenario(name, None, data, model)
            for name in (names or SCENARIOS)}


def run_of(z: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}


def block_of(leaf: np.ndarray, M: int, i: int) -> np.ndarray:
    """Model index i's block of a whole leaf, ``group_param_pspec``'s."""
    d = model_dim(leaf.shape, M)
    if d is None:
        return leaf
    size = leaf.shape[d] // M
    return np.take(leaf, np.arange(i * size, (i + 1) * size), axis=d)


def cols_of(rows: np.ndarray, M: int, i: int) -> np.ndarray:
    """Model index i's block of the columns of a (·, d_w) array
    (``FedMesh.model_cols``)."""
    d = rows.shape[1]
    return rows[:, i * d // M:(i + 1) * d // M]


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_matches_one(got: dict, ref: dict, M: int, i: int):
    """Rank at model index i against the run of one: host state equal,
    metrics at the tolerances above, each stored leaf its block of the
    one-device leaf in shape exactly and within ``LEAF_RTOL``, the whole
    replicas (update directions, FeSEM's rows) and the cached directions'
    column blocks within ``LEAF_RTOL``."""
    assert sorted(got) == sorted(ref)
    for k in EXACT:
        if k in ref:
            assert np.array_equal(got[k], ref[k]), k
    h, hr = got["hist"], ref["hist"]
    assert h.shape == hr.shape
    np.testing.assert_array_equal(h[:, 3], hr[:, 3])        # quarantined
    np.testing.assert_allclose(h[:, 0], hr[:, 0], atol=ACC_ATOL, rtol=0)
    np.testing.assert_allclose(h[:, 1:3], hr[:, 1:3], rtol=RTOL)
    leaves = [k for k in ref if k.startswith("gp/")]
    assert leaves
    for k in leaves:
        want = block_of(ref[k], M, i)
        assert got[k].shape == want.shape, (k, got[k].shape, want.shape)
        assert rel_err(got[k], want) <= LEAF_RTOL, (k, rel_err(got[k], want))
    for k in WHOLE + COLS:
        if k in ref:
            want = cols_of(ref[k], M, i) if k in COLS else ref[k]
            assert got[k].shape == want.shape, k
            assert rel_err(got[k], want) <= LEAF_RTOL, k
    if "eval" in ref:
        np.testing.assert_allclose(got["eval"], ref["eval"], atol=ACC_ATOL,
                                   rtol=0)


def assert_replicas(ranks: list, M: int, name: str):
    """Every rank's whole state equal bit for bit; each stored leaf and
    column block equal on the ranks of one model index (one a data
    slice)."""
    runs = [run_of(z, name) for z in ranks]
    for r, z in enumerate(runs[1:], 1):
        assert sorted(z) == sorted(runs[0])
        for k, v in z.items():
            if k == "cohort_rows":
                continue
            peer = (runs[r % M] if k.startswith("gp/") or k in COLS
                    else runs[0])
            assert v.shape == peer[k].shape and \
                v.tobytes() == peer[k].tobytes(), (r, k)


# ---------------------------------------------------------------------------
# the runtime services (``_torch_mesh_driver.SERVICES``) on a model axis
# ---------------------------------------------------------------------------
# a services run's per-rank arrays: the rows a rank holds, whether its
# telemetry bundle records and writes
PER_RANK = ("cohort_rows", "obs")


def service_references(names, work) -> dict:
    """{scenario: its arrays} of the services' scenarios ``names`` run in
    this process on one device (``mesh=None``), their files under
    ``work``."""
    from _torch_mesh_driver import run_service
    data, model = fixture()
    return {name: run_service(name, None, data, model, work / name)
            for name in names}


def assert_service_matches_one(got: dict, ref: dict, M: int, i: int):
    """A services run at model index i against the run of one: counts,
    membership and the replicated host state equal, the histories at the
    1-D mesh tests' tolerances, each stored parameter leaf its block of the
    one-device leaf (``group_param_pspec``) in shape exactly and within
    ``LEAF_RTOL``, the update directions whole and a streamed table's
    cached directions its columns, both within ``LEAF_RTOL``."""
    from _torch_mesh_driver import assert_sharded_close
    blocked = dict(got)
    whole = dict(ref)
    for k in ref:
        if k.startswith(("gp/", "params/")):
            want = block_of(ref[k], M, i)
            assert got[k].shape == want.shape, (k, got[k].shape, want.shape)
            whole[k] = want
        elif k in COLS:
            whole[k] = cols_of(ref[k], M, i)
    assert rel_err(got["group_delta"], ref["group_delta"]) <= LEAF_RTOL
    assert_sharded_close(blocked, whole)


def assert_service_replicas(ranks: list, M: int, name: str):
    """Every rank's whole state equal bit for bit (but what is per rank by
    design); each stored block equal on the ranks of one model index."""
    runs = [run_of(z, name) for z in ranks]
    for r, z in enumerate(runs[1:], 1):
        assert sorted(z) == sorted(runs[0])
        for k, v in z.items():
            if k in PER_RANK:
                continue
            peer = (runs[r % M] if k.startswith(("gp/", "params/"))
                    or k in COLS else runs[0])
            assert v.shape == peer[k].shape and \
                v.tobytes() == peer[k].tobytes(), (r, k)
