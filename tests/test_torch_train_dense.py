"""LM training of the port's dense, VLM and audio families against the JAX
package, on the CPU at the smoke variants (2 layers, d_model 256, fp32):
the JAX ``init_train_state`` carried across with ``train_state_from_numpy``
and one batch made from a seed with numpy (a few labels masked), fed to
both.

Tolerances: loss and metrics 1e-4 (absolute); every gradient leaf 2e-5 of
the leaf's largest ``jax.grad`` magnitude (measured ≤ 2e-6: fp32 sums in
another order); after three AdamW steps (lr 1e-2), each step's loss within
1e-3 (measured ≤ 1e-4), each leaf of params, ``mu`` and ``nu`` within 2e-3
in Frobenius norm relative to the reference's (measured ≤ 4.5e-4),
InternVL2's params within 2e-2 (measured 6.3e-3; the JAX package jitted
against op by op differs from itself by 5.7e-3 there: AdamW's first update
is about lr·sign(g), and elements whose gradient is at the level of
rounding step either way)."""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_train import check_loss_and_grads, check_three_steps

ARCHS = ("gemma-2b", "glm4-9b", "granite-20b", "nemotron-4-15b",
         "internvl2-1b", "hubert-xlarge")
GRAD_TOL = 2e-5
STEP_TOL = {"loss": 1e-3, "params": 2e-3, "mu": 2e-3, "nu": 2e-3}
VLM_STEP_TOL = dict(STEP_TOL, params=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_reference(arch):
    check_three_steps(arch, VLM_STEP_TOL if arch == "internvl2-1b"
                      else STEP_TOL)
