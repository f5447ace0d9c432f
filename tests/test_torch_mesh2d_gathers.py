"""The mesh's gathers (``launch/mesh.py``) on a gloo world of CPU ranks,
each rank a process of its own: ``gather_rows``, ``gather_cols`` and
``model_gather`` by both of their routes, the ``all_gather`` / ``reduce``
one NCCL and the dry run's fake group take and the zero-filled
``all_reduce`` one gloo takes for CUDA tensors (gloo runs both on CPU
tensors), held to the whole tensor exactly, with uneven row pieces and
column blocks and a cohort the data shards do not divide.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"

RANK = """
import sys, torch
from repro_torch.launch import mesh as mesh_lib
rank, world, model, store, gathers = (int(sys.argv[1]), int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4],
                                      sys.argv[5] == "1")
torch.set_num_threads(1)
mesh_lib.init_process_group("cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
try:
    m = mesh_lib.make_fed_mesh(world // model, model, device="cpu")
    m._gathers = lambda: gathers
    m.comm_log = []
    for k, d in ((10, 13), (12, 16), (7, 9)):
        full = torch.arange(k * d, dtype=torch.float32).view(k, d) - 40.0
        rows = m.compute_rows(k)
        mine = full if rows is None else full[rows[0]:rows[1]]
        if rows is not None:
            assert torch.equal(m.gather_rows(mine, k), full), (k, d)
        c0, c1 = m.model_cols(d)
        got = m.gather_cols(mine, k)
        assert torch.equal(got, full[:, c0:c1]), (k, d, got.shape)
        assert torch.equal(m.model_gather(full[:, c0:c1].contiguous(), 1, d),
                           full)
    R = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * m.model_index
    want = torch.cat([torch.arange(6, dtype=torch.float32).view(2, 3)
                      + 10 * j for j in range(model)])
    assert torch.equal(m.model_gather(R, 0), want)
    kinds = {kind for kind, _, _ in m.comm_log}
    assert kinds == ({"all_gather", "reduce"} if gathers else {"all_reduce"}
                     ) or model == 1, kinds
    # gloo's reduce returns on a sender before its receiver is done: meet
    # before the groups are torn down
    torch.distributed.barrier()
finally:
    mesh_lib.destroy_process_group()
"""


@pytest.mark.parametrize("gathers", [False, True])
@pytest.mark.parametrize("world,model", [(4, 2), (2, 2), (3, 3), (2, 1)])
def test_gathers_give_the_whole(tmp_path, world, model, gathers):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), str(model),
         str(store), "1" if gathers else "0"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, \
        "\n".join(log[-3000:] for log in logs)
