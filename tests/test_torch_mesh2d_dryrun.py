"""The federated dry run on the production mesh (``launch/fed_dryrun.py``):
rank 0's program on ``meta`` inside a ``fake`` process group of 256 ranks
(16 × 16) or 512 (``--multi-pod``: 2 × 16 × 16), each CLI run in a process
of its own so this one keeps no process group.

Held exactly: the record's keys (the reference's ``mesh``,
``memory_analysis``, ``cost_analysis``, ``collective_bytes_total``,
``collective_bytes_by_kind``, ``n_collectives``, and ``differences``);
the cold start's argument bytes, a rank's ΔW block of 64 × 25,953,664
fp32 (6,644,137,984 bytes) with Ω; CholeskyQR2's 16 all-reduces over the
model group (2 for each of the 5 tall QRs, 4 for Aᵀ Q, 1 for Qᵀ A, 1 for
E's packed partial sums) and Householder's 6 all-reduces and 5
all-gathers (TSQR: one gather of the R factors a tall QR: the fake
group, as NCCL, gathers); the round's 3 gathers of the divisible group
leaves over the model group and its 4 collectives over the world.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
DW_BLOCK_BYTES = 64 * (415_258_624 // 16) * 4           # 6,644,137,984
OMEGA_BYTES = 64 * 13 * 4
KEYS = {"workload", "mesh", "axes", "qr", "status", "argument_shapes",
        "trace_s", "memory_analysis", "cost_analysis", "differences",
        "collective_bytes_total", "collective_bytes_by_kind",
        "n_collectives", "collectives_by_op", "collectives_by_group"}


def _record(tmp_path, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fed_dryrun", *args,
         "--out", str(tmp_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout[out.stdout.index("{"):])


@pytest.mark.parametrize("qr,n_reduce,n_gather", [("cholesky", 16, 0),
                                                  ("householder", 6, 5)])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_coldstart_on_the_production_mesh(tmp_path, multi_pod, qr, n_reduce,
                                          n_gather):
    rec = _record(tmp_path, "--workload", "coldstart", "--qr", qr,
                  *(["--multi-pod"] if multi_pod else []))
    assert set(rec) == KEYS
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["axes"] == (["pod", "data", "model"] if multi_pod
                           else ["data", "model"])
    assert rec["argument_shapes"] == [[64, 415_258_624 // 16], [64, 13]]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        DW_BLOCK_BYTES + OMEGA_BYTES
    n_model = n_reduce + n_gather
    assert rec["n_collectives"] == n_model
    assert rec["collectives_by_group"] == {"model": {
        "n": n_model, "bytes": rec["collective_bytes_total"]}}
    ops = {"c10d.allreduce_": n_reduce, "c10d._allgather_base_": n_gather}
    assert rec["collectives_by_op"] == {k: v for k, v in ops.items() if v}
    by_kind = rec["collective_bytes_by_kind"]
    assert sum(by_kind.values()) == rec["collective_bytes_total"]
    assert set(by_kind) == ({"all_reduce", "all_gather"} if n_gather
                            else {"all_reduce"})
    if n_gather:
        # the 5 gathers of the M (13, 13) R factors, each 16 × 13 × 13 fp32
        assert by_kind["all_gather"] == 5 * 16 * 13 * 13 * 4
    assert "collectives" in rec["differences"]


def test_mesh_of_one_keeps_its_record(tmp_path):
    rec = _record(tmp_path, "--mesh", "1", "--workload", "coldstart",
                  "--dw", "4096")
    assert rec["mesh"] == "1" and "n_collectives" not in rec
    assert rec["argument_shapes"] == [[64, 4096], [64, 13]]
