"""The federated dry run's round on the production mesh
(``launch/fed_dryrun.py``, ``tests/test_torch_mesh2d_dryrun.py``'s
harness): rank 0's round on ``meta`` in a ``fake`` world of 256 or 512
ranks, in a process of its own.

Held exactly: the record's keys; a rank's arguments (its data slice's
cohort rows, 64 or 32 of K = 1,024; its blocks of the group parameters:
w1 784 / 16 rows, b1 and w2 512 / 16, b2's 62 whole); 3 gathers of the
divisible leaves over the model group (each the whole leaf's bytes) and
4 collectives over the world.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_mesh2d_dryrun import KEYS, _record


@pytest.mark.parametrize("multi_pod", [False, True])
def test_round_on_the_production_mesh(tmp_path, multi_pod):
    rec = _record(tmp_path, "--workload", "round",
                  *(["--multi-pod"] if multi_pod else []))
    assert set(rec) == KEYS
    rows = 1024 // (32 if multi_pod else 16)        # the data slice's
    shapes = rec["argument_shapes"]
    # b1, b2, w1, w2 blocks: 784 / 16, 512 / 16 and 62 whole
    assert shapes[:4] == [[5, 32], [5, 62], [5, 49, 512], [5, 32, 62]]
    assert shapes[5] == [rows, 256, 784] and shapes[6] == [rows, 256]
    by = rec["collectives_by_group"]
    assert by["model"]["n"] == 3 and by["world"]["n"] == 4
    # each gather gives a whole leaf: w1, b1, w2 in fp32
    assert by["model"]["bytes"] == 4 * 5 * (784 * 512 + 512 + 512 * 62)

