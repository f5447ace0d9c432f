"""FedGrouProx and the RAC / RCC ablations of the port against the JAX
package (the harness of tests/test_torch_fedgroup.py, same tolerances:
mean_loss and discrepancy rtol 1e-3, weighted accuracy 0.01 absolute,
memberships equal)."""
from test_torch_fedgroup import _assert_rounds_agree, _cfg, _pair
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.fedgroup import FedGrouProxTrainer


def test_fedgrouprox_and_ablations_match_reference():
    jcfg = _cfg(measure="edc", mu=0.01, rac=True)
    jtr, ttr = _pair(jcfg, FedGrouProxTrainer)
    assert ttr.cfg.mu == 0.01
    _assert_rounds_agree(jtr, ttr)
    jtr, ttr = _pair(_cfg(rcc=True))
    _assert_rounds_agree(jtr, ttr)
