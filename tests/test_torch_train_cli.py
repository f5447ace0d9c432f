"""The port's ``--mode lm`` on the CPU, its ``state.npz`` across the two
packages, and remat on against off.

  * ``python -m repro_torch.launch.train --mode lm --smoke --device cpu
    --steps 2 --out DIR`` for one arch of each family: the reference's
    header and step lines, finite losses, ``DIR/state.npz`` with
    ``{"arch", "steps"}``, which loads in the reference's ``load_pytree``
    against the shapes of a JAX ``init_train_state`` (keys, shapes and
    dtypes; the values equal to the port's own load);
  * the reference's archive of a JAX train state loads in the port's
    against a port template;
  * a smoke variant with ``remat=True`` takes one ``train_step`` equal bit
    for bit to ``remat=False`` (each layer body checkpointed changes no
    value)."""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_train import jax_state, port_state, train_batches
from _torch_zoo import cfgs
from repro.checkpoint import io as jckpt
from repro.models import zoo as jzoo
from repro_torch.checkpoint import io as tckpt
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILY_ARCHS = ("gemma-2b", "internvl2-1b", "hubert-xlarge",
                "granite-moe-1b-a400m", "zamba2-1.2b", "xlstm-350m")


def _run_lm(arch: str, out: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
         "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--out", out], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_cli_trains_each_family_on_cpu(arch, tmp_path):
    out = _run_lm(arch, str(tmp_path))
    lines = out.splitlines()
    assert re.match(rf"# LM training {arch} \(smoke\): [\d,]+ params",
                    lines[0])
    steps = [re.match(r"step\s+(\d+) loss=([\d.]+) \(", ln) for ln in lines]
    assert [int(m.group(1)) for m in steps if m] == [0, 1]
    assert all(np.isfinite(float(m.group(2))) for m in steps if m)
    path = str(tmp_path / "state.npz")
    assert tckpt.load_metadata(path) == {"arch": arch, "steps": 2}
    # the port's state.npz in the reference's strict load, against the
    # shapes of a JAX init_train_state, equal to the port's own load
    cfg, jcfg = cfgs(arch)
    template = jax.eval_shape(lambda k: jzoo.init_train_state(k, jcfg),
                              jax.random.PRNGKey(0))
    got = jckpt.load_pytree(path, template)
    ours = tckpt.load_pytree(path, zoo.init_train_state(
        torch.Generator().manual_seed(9), cfg, device="cpu"))
    assert int(got["step"]) == int(ours["step"]) == 2
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(ours)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_reference_state_loads_in_the_port(tmp_path):
    path = str(tmp_path / "state.npz")
    jst = jax_state("xlstm-350m")
    jckpt.save_pytree(path, jst, {"arch": "xlstm-350m", "steps": 0})
    template = port_state("gemma-2b")          # another arch: refused
    with pytest.raises(ValueError, match="does not match the template"):
        tckpt.load_pytree(path, template)
    template = zoo.init_train_state(torch.Generator().manual_seed(9),
                                    cfgs("xlstm-350m")[0], device="cpu")
    got = tckpt.load_pytree(path, template)
    assert isinstance(got["params"]["blocks_list"], list)
    for a, b in zip(jax.tree_util.tree_leaves(jst), tree_leaves(got)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m"])
def test_remat_train_step_equals_no_remat_bit_for_bit(arch):
    cfg, _ = cfgs(arch)
    _, tb = train_batches(cfg)
    on, m_on = zoo.train_step(port_state(arch), tb, cfg.replace(remat=True))
    off, m_off = zoo.train_step(port_state(arch), tb,
                                cfg.replace(remat=False))
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)
