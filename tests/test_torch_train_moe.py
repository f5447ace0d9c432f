"""LM training of the port's MoE family against the JAX package, on the
CPU at the smoke variants (2 layers, d_model 256, 4 experts, top 2, fp32):
Granite-MoE under both dispatches (``moe_impl`` scatter and grouped), and
DeepSeek-V3 (MLA) without and with the MTP head, and with MLA's query
chunks (``attn_q_chunk``) under remat. The JAX ``init_train_state`` is
carried across with ``train_state_from_numpy``; one batch made from a seed
with numpy (a few labels masked) is fed to both.

Tolerances: loss and every metric (``ce``, ``mtp_ce``, the load-balance
and router z-losses) 1e-4 (absolute); every gradient leaf 2e-5 of the
leaf's largest ``jax.grad`` magnitude (measured ≤ 2.2e-6); after three
AdamW steps (lr 1e-2), each step's loss within 1e-3 (measured ≤ 1e-5) and
each leaf of params, ``mu`` and ``nu`` within 2e-3 in Frobenius norm
relative to the reference's (measured ≤ 1.2e-4; AdamW's first update is
about lr·sign(g), so elements whose gradient is at the level of rounding
step either way)."""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_train import (check_loss_and_grads, check_three_steps,
                          port_loss_and_grads)

CASES = {"granite-moe": ("granite-moe-1b-a400m", {}),
         "granite-moe-grouped": ("granite-moe-1b-a400m",
                                 {"moe_impl": "grouped"}),
         "deepseek": ("deepseek-v3-671b", {}),
         "deepseek-mtp": ("deepseek-v3-671b", {"mtp": True})}
GRAD_TOL = 2e-5
STEP_TOL = {"loss": 1e-3, "params": 2e-3, "mu": 2e-3, "nu": 2e-3}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    arch, kw = CASES[case]
    check_loss_and_grads(arch, GRAD_TOL, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_adamw_steps_match_reference(case):
    arch, kw = CASES[case]
    check_three_steps(arch, STEP_TOL, **kw)


def test_mla_query_chunks_under_remat_change_no_value():
    """DeepSeek with ``attn_q_chunk`` 4 (of S = 16): its query chunks
    checkpointed with remat on, not without; loss and every gradient equal
    bit for bit."""
    kw = {"attn_q_chunk": 4}
    on = port_loss_and_grads("deepseek-v3-671b", remat=True, **kw)
    off = port_loss_and_grads("deepseek-v3-671b", remat=False, **kw)
    assert on[0] == off[0] and on[1] == off[1]
    assert all((a == b).all() for a, b in zip(on[2], off[2]))
