"""``--mode fed`` under torchrun on two CPU ranks: rank 0's lines equal the
world-of-one CLI's (each round line's host seconds left out), and only
rank 0 prints; with ``--async-depth 1 --telemetry-dir`` too, where rank 0
alone writes the directory and ``check_dir`` passes it."""
import os
import re
import subprocess
import sys
from pathlib import Path

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.launch.inspect import check_dir

SRC = Path(__file__).resolve().parents[1] / "src"
ARGS = ["-m", "repro_torch.launch.train", "--mode", "fed", "--device", "cpu",
        "--framework", "fedgroup", "--dataset", "synthetic", "--rounds", "2",
        "--k", "8", "--epochs", "2", "--groups", "3", "--alpha", "2",
        "--clients", "20"]


def _lines(cmd, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return [re.sub(r" \(\d+\.\d+s\)$", "", line)
            for line in proc.stdout.splitlines()]


def test_torchrun_two_ranks_print_the_world_of_one_lines(tmp_path):
    one = _lines([sys.executable, *ARGS], tmp_path)
    two = _lines([sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc_per_node", "2", *ARGS], tmp_path)
    assert one[0].startswith("# fedgroup on synthetic")
    assert [ln for ln in one if ln.startswith("round ")][1:]
    assert two == one


def test_torchrun_async_and_telemetry_print_the_world_of_one_lines(tmp_path):
    extra = ["--async-depth", "1", "--telemetry-dir", "tel"]
    runs = {}
    for tag, cmd in (("one", [sys.executable, *ARGS, *extra]),
                     ("two", [sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc_per_node", "2", *ARGS,
                              *extra])):
        (tmp_path / tag).mkdir()
        runs[tag] = _lines(cmd, tmp_path / tag)
    one, two = runs["one"], runs["two"]
    assert one[0].endswith("async_depth=1")
    assert any(ln.startswith("async: folds=2") for ln in one)
    assert two == one
    for tag in runs:
        tel = tmp_path / tag / "tel"
        assert sorted(p.name for p in tel.iterdir()) == [
            "metrics.jsonl", "run_summary.json", "trace.json"]
        assert check_dir(str(tel)) == []
    assert (tmp_path / "one" / "tel" / "metrics.jsonl").read_text().count(
        "\n") == 2
