"""``--mode fed --model-axis 2`` under torchrun on two CPU ranks (a ``(1,
2)`` mesh) with ``--checkpoint-dir`` and ``--resume``: rank 0's round
lines equal the world-of-one CLI's (each line's host seconds left out),
and a run stopped after two rounds and resumed from its archive prints
the uninterrupted run's third round. ``--telemetry-dir`` and
``--async-depth``: ``tests/test_torch_mesh2d_cli_async.py``."""
import sys

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.launch.inspect import check_dir
from test_torch_mesh_cli import ARGS, _lines

TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2"]
AXIS = ["--model-axis", "2"]


def _rounds(lines):
    return [ln for ln in lines if ln.startswith("round ")]


def test_model_axis_checkpoint_and_resume_print_the_world_of_one_lines(
        tmp_path):
    one = _lines([sys.executable, *ARGS, "--rounds", "3"], tmp_path)
    first = _lines([*TORCHRUN, *ARGS, *AXIS, "--checkpoint-dir", "ck"],
                   tmp_path)
    back = _lines([*TORCHRUN, *ARGS, *AXIS, "--rounds", "3",
                   "--checkpoint-dir", "ck", "--resume"], tmp_path)
    assert _rounds(first) == _rounds(one)[:2]
    assert "resumed from ck after round 2" in back
    assert _rounds(back) == _rounds(one)[2:]
    assert back[-1] == one[-1]                          # max_acc
    # an archive a round, every leaf whole
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == [f"ckpt_{t:08d}.npz" for t in (1, 2, 3)]
    specs = ckpt_io.saved_array_specs(str(tmp_path / "ck" / names[-1]))
    assert specs["model/group_params/w"][0] == (3, 60, 10)
