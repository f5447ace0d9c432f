"""The port's MoE layer (``models/moe.py``) and the zoo's MoE family
without MLA (Granite-3.0-1B-A400M) against the JAX package, on the CPU.

The layer is held on y and all three aux fields within 2e-5 for both
dispatches, with a capacity that drops tokens (``capacity_factor`` 0.5)
and with ample ones (1.25 and 100): the in-expert rank, the capacity's
rounding and the combine all show there. The model is held as the dense
family is (tests/test_torch_zoo_dense.py): forward logits and serve steps
1e-4, serve against forward 2e-3 with ``capacity_factor=100`` (no drops),
as tests/test_decode_consistency.py holds the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CONSIST_TOL, FULL_PARAMS, LOGIT_TOL, batches, cfgs,
                        jax_tree_paths, np_, param_count_of_port,
                        param_count_of_reference, params,
                        serve_against_forward, serve_both, tree_paths)
from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import zoo

MOE_TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "granite-moe-1b-a400m"
IMPLS = {"scatter": (tmoe.moe_apply, jmoe.moe_apply),
         "grouped": (tmoe.moe_apply_grouped, jmoe.moe_apply_grouped)}


def _layer(n_shared: int, gated: bool = True):
    jp = jmoe.init_moe(jax.random.PRNGKey(3), 32, 24, 6, n_shared=n_shared,
                       gated=gated)
    return jp, params_from_numpy(jp)


@pytest.mark.parametrize("n_shared,gated", [(0, True), (1, True),
                                            (0, False)])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 100.0])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_moe_apply_matches_reference(impl, capacity_factor, n_shared, gated):
    ours, theirs = IMPLS[impl]
    jp, tp = _layer(n_shared, gated)
    x = np.random.default_rng(5).normal(size=(3, 20, 32)).astype(np.float32)
    act = "silu" if gated else "relu2"
    yj, aj = theirs(jp, jnp.asarray(x), top_k=2,
                    capacity_factor=capacity_factor, act=act)
    yt, at = ours(tp, torch.as_tensor(x), top_k=2,
                  capacity_factor=capacity_factor, act=act)
    np.testing.assert_allclose(np_(yt), np_(yj), **MOE_TOL)
    for field in tmoe.MoEAux._fields:
        np.testing.assert_allclose(np_(getattr(at, field)),
                                   np_(getattr(aj, field)), **MOE_TOL)
    assert float(at.expert_load.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_a_small_capacity_drops_tokens(impl):
    """capacity_factor 0.5 really drops: y differs from the ample run's on
    some tokens and equals it on others (the first ranks of each expert
    fit either way)."""
    ours, _ = IMPLS[impl]
    _, tp = _layer(0)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(3, 20, 32)).astype(np.float32))
    small, _ = ours(tp, x, top_k=2, capacity_factor=0.5)
    ample, _ = ours(tp, x, top_k=2, capacity_factor=100.0)
    same = torch.isclose(small, ample, atol=1e-6).all(-1)
    assert 0 < int(same.sum()) < same.numel()


@pytest.mark.parametrize("tokens", [1, 3, 7, 20, 51, 60, 100, 1000, 8192])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 100.0])
def test_capacity_rounds_as_the_reference(tokens, capacity_factor):
    """Python's round (half to even), at least 1, up to a multiple of 8."""
    for top_k, E in ((2, 4), (8, 32), (2, 6)):
        c = max(1, int(round(tokens * top_k / E * capacity_factor)))
        assert (tmoe._capacity(tokens, top_k, E, capacity_factor)
                == (c + 7) // 8 * 8)


def test_init_moe_tree_matches_reference():
    jp, _ = _layer(2)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), 32, 24, 6,
                       n_shared=2)
    assert tree_paths(tp) == jax_tree_paths(jp)
    assert tp["router"].dtype == torch.float32
    tp16 = tmoe.init_moe(torch.Generator().manual_seed(0), 32, 24, 6,
                         dtype=torch.bfloat16)
    assert tp16["router"].dtype == torch.float32       # fp32 router always
    assert tp16["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Granite-MoE, the whole smoke model
# ---------------------------------------------------------------------------

def test_config_and_smoke_variant_equal_reference():
    assert registry.get(ARCH).__dict__ == jreg.get(ARCH).__dict__
    ours, ref = cfgs(ARCH)
    assert ours.__dict__ == ref.__dict__


def test_full_param_count_equals_reference():
    assert (param_count_of_port(ARCH) == param_count_of_reference(ARCH)
            == FULL_PARAMS[ARCH])


def test_init_params_tree_matches_reference():
    jp, _ = params(ARCH)
    cfg, _ = cfgs(ARCH)
    ours = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert tree_paths(ours) == jax_tree_paths(jp)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
@pytest.mark.parametrize("impl", ["scatter", "grouped"])
def test_forward_logits_and_aux_match_reference(impl, capacity_factor):
    cfg, jcfg = cfgs(ARCH, moe_impl=impl, capacity_factor=capacity_factor)
    jp, tp = params(ARCH)
    jb, tb = batches(cfg, 0, 2, 32)
    want, jaux = jzoo.forward(jp, jcfg, jb)
    got, aux = zoo.forward(tp, cfg, tb)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)
    for k in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(np_(aux[k]), np_(jaux[k]), **MOE_TOL)
        assert float(aux[k]) > 0


def test_serve_steps_match_reference():
    """16 decode steps (the scatter dispatch, whatever ``moe_impl``)."""
    lj, lt, jc, tc = serve_both(ARCH, 16, moe_impl="grouped")
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)
    for k in jc:
        np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["scatter", "grouped"])
def test_serve_matches_forward(impl):
    cfg, _ = cfgs(ARCH, moe_impl=impl, capacity_factor=100.0)
    _, tp = params(ARCH)
    full, dec = serve_against_forward(cfg, tp, 2, 16, 16)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)
