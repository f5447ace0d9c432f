"""``--mode fed`` under torchrun on two CPU ranks: rank 0's lines equal the
world-of-one CLI's (each round line's host seconds left out), and only
rank 0 prints."""
import os
import re
import subprocess
import sys
from pathlib import Path

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
ARGS = ["-m", "repro_torch.launch.train", "--mode", "fed", "--device", "cpu",
        "--framework", "fedgroup", "--dataset", "synthetic", "--rounds", "2",
        "--k", "8", "--epochs", "2", "--groups", "3", "--alpha", "2",
        "--clients", "20"]


def _lines(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
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
