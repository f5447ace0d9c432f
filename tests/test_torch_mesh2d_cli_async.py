"""``--mode fed --model-axis 2`` under torchrun on two CPU ranks (a ``(1,
2)`` mesh) with ``--async-depth 1 --telemetry-dir``: rank 0's lines equal
the world-of-one CLI's, and rank 0 alone writes the telemetry directory,
which ``check_dir`` passes."""
import sys

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.launch.inspect import check_dir
from test_torch_mesh2d_cli import AXIS, TORCHRUN
from test_torch_mesh_cli import ARGS, _lines


def test_model_axis_async_and_telemetry_print_the_world_of_one_lines(
        tmp_path):
    extra = ["--async-depth", "1", "--telemetry-dir", "tel"]
    runs = {}
    for tag, cmd in (("one", [sys.executable, *ARGS, *extra]),
                     ("two", [*TORCHRUN, *ARGS, *AXIS, *extra])):
        (tmp_path / tag).mkdir()
        runs[tag] = _lines(cmd, tmp_path / tag)
    assert runs["two"] == runs["one"]
    assert any(ln.startswith("async: folds=2") for ln in runs["two"])
    tel = tmp_path / "two" / "tel"
    assert check_dir(str(tel)) == []
    assert (tel / "metrics.jsonl").read_text().count("\n") == 2
