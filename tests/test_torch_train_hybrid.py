"""LM training of the port's hybrid (Zamba2: Mamba2 with the shared
attention block) and ``ssm`` (xLSTM) families against the JAX package, on
the CPU at the smoke variants (2 layers, d_model 256, fp32; Zamba2's SSD
chunk 16, xLSTM's chunk 8): the JAX ``init_train_state`` carried across
with ``train_state_from_numpy`` and one batch made from a seed with numpy
(a few labels masked), fed to both. xLSTM also with the chunkwise mLSTM.

Tolerances: loss and metrics 1e-4 (absolute); every gradient leaf 2e-5 of
the leaf's largest ``jax.grad`` magnitude (measured ≤ 3e-6). After three
AdamW steps (lr 1e-2): Zamba2's losses within 1e-3 and each leaf of
params, ``mu`` and ``nu`` within 2e-3 in Frobenius norm relative to the
reference's (measured ≤ 2.3e-4). xLSTM's within 1e-2 (losses; measured
3e-3), 0.1 (params, ``mu``; measured 0.025, 0.035) and 0.2 (``nu``;
measured 0.067): its sLSTM post-FFN grows the residual stream, so the
rounding of one step moves the next ones' gradients, and the JAX package
jitted against op by op differs from itself by 2.4e-4 in the third loss
and 0.025 / 0.006 / 0.013 in params / ``mu`` / ``nu``."""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_train import (check_loss_and_grads, check_three_steps,
                          port_loss_and_grads)

CASES = {"zamba2": ("zamba2-1.2b", {}), "xlstm": ("xlstm-350m", {}),
         "xlstm-chunkwise": ("xlstm-350m", {"mlstm_impl": "chunkwise"})}
GRAD_TOL = 2e-5
STEP_TOL = {"zamba2": {"loss": 1e-3, "params": 2e-3, "mu": 2e-3,
                       "nu": 2e-3},
            "xlstm": {"loss": 1e-2, "params": 0.1, "mu": 0.1, "nu": 0.2}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    arch, kw = CASES[case]
    check_loss_and_grads(arch, GRAD_TOL, **kw)


@pytest.mark.parametrize("case", ["zamba2", "xlstm"])
def test_three_adamw_steps_match_reference(case):
    arch, kw = CASES[case]
    check_three_steps(arch, STEP_TOL[case], **kw)


@pytest.mark.parametrize("arch,kw", [
    ("zamba2-1.2b", {}), ("xlstm-350m", {}),
    ("xlstm-350m", {"xlstm_scan_units": True,
                    "xlstm_pattern": ("m", "s", "m", "s"), "n_layers": 4})],
    ids=["zamba2", "xlstm", "xlstm-units"])
def test_remat_changes_no_value(arch, kw):
    """Each layer body (xLSTM: each block, each unit, each chunk of the
    recurrent scans) checkpointed with remat on: loss and every gradient
    equal to remat off, bit for bit."""
    on = port_loss_and_grads(arch, remat=True, **kw)
    off = port_loss_and_grads(arch, remat=False, **kw)
    assert on[0] == off[0] and on[1] == off[1]
    assert all((a == b).all() for a, b in zip(on[2], off[2]))
