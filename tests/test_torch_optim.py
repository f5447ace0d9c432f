"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the same numpy inputs, and
``tests/test_optim_checkpoint.py``'s formula cases on the port. Both
compute in fp32 in the same order: equal within rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro import optim as jopt
from repro_torch import optim as topt

TOL = dict(rtol=1e-6, atol=1e-7)


def _trees(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 5), "b": (5,), "emb": (3, 2, 2)}
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


def test_sgd_and_proximal_match_reference():
    p, g, a = _trees(0)
    _close(topt.sgd_update(_t(p), _t(g), 0.1),
           jopt.sgd_update(_j(p), _j(g), 0.1))
    _close(topt.proximal_grad(_t(p), _t(a), 0.5),
           jopt.proximal_grad(_j(p), _j(a), 0.5))


def test_momentum_matches_reference_over_steps():
    p, g, _ = _trees(1)
    tp, tv = _t(p), topt.momentum_init(_t(p))
    jp, jv = _j(p), jopt.momentum_init(_j(p))
    for step in range(3):
        gs = {k: v * (step + 1) for k, v in g.items()}
        tp, tv = topt.momentum_update(tp, _t(gs), tv, lr=0.05, beta=0.9)
        jp, jv = jopt.momentum_update(jp, _j(gs), jv, lr=0.05, beta=0.9)
    _close(tp, jp)
    _close(tv, jv)
    assert all(v.dtype == torch.float32 for v in tv.values())


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference_over_steps(weight_decay):
    p, g, _ = _trees(2)
    tp, to = _t(p), topt.adamw_init(_t(p))
    jp, jo = _j(p), jopt.adamw_init(_j(p))
    for step in range(4):
        gs = {k: v - 0.1 * step for k, v in g.items()}
        tp, to = topt.adamw_update(tp, _t(gs), to, lr=1e-2,
                                   weight_decay=weight_decay)
        jp, jo = jopt.adamw_update(jp, _j(gs), jo, lr=1e-2,
                                   weight_decay=weight_decay)
    _close(tp, jp)
    _close(to["mu"], jo["mu"])
    _close(to["nu"], jo["nu"])
    assert int(to["step"]) == int(jo["step"]) == 4


def test_bf16_params_keep_their_dtype_with_fp32_state():
    p, g, _ = _trees(3)
    tp = {k: v.to(torch.bfloat16) for k, v in _t(p).items()}
    out, opt = topt.adamw_update(tp, _t(g), topt.adamw_init(tp), lr=1e-2)
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    assert all(v.dtype == torch.float32 for v in opt["mu"].values())


def test_cosine_schedule_matches_reference():
    for step in (0, 3, 10, 11, 55, 99, 100, 150):
        got = float(topt.cosine_schedule(step, base_lr=0.3, warmup=10,
                                         total=100))
        want = float(jopt.cosine_schedule(step, base_lr=0.3, warmup=10,
                                          total=100))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), step


# tests/test_optim_checkpoint.py's formula cases, on the port
def test_sgd_matches_formula():
    out = topt.sgd_update({"w": torch.tensor([1.0, 2.0])},
                          {"w": torch.tensor([0.5, -1.0])}, 0.1)
    np.testing.assert_allclose(out["w"].numpy(), [0.95, 2.1], rtol=1e-6)


def test_momentum_accumulates():
    p, g = {"w": torch.zeros(2)}, {"w": torch.ones(2)}
    v = topt.momentum_init(p)
    p, v = topt.momentum_update(p, g, v, lr=1.0, beta=0.9)
    p, v = topt.momentum_update(p, g, v, lr=1.0, beta=0.9)
    np.testing.assert_allclose(v["w"].numpy(), 1.9, rtol=1e-6)
    np.testing.assert_allclose(p["w"].numpy(), -2.9, rtol=1e-6)


def test_adamw_first_step_is_lr_sized():
    p = {"w": torch.tensor([0.0])}
    p2, _ = topt.adamw_update(p, {"w": torch.tensor([3.0])},
                              topt.adamw_init(p), lr=0.1, weight_decay=0.0)
    np.testing.assert_allclose(p2["w"].numpy(), [-0.1], atol=1e-5)


def test_adamw_weight_decay_shrinks():
    p = {"w": torch.tensor([10.0])}
    p2, _ = topt.adamw_update(p, {"w": torch.tensor([0.0])},
                              topt.adamw_init(p), lr=0.1, weight_decay=0.1)
    assert float(p2["w"][0]) < 10.0


def test_proximal_grad():
    g = topt.proximal_grad({"w": torch.tensor([2.0])},
                           {"w": torch.tensor([1.0])}, mu=0.5)
    np.testing.assert_allclose(g["w"].numpy(), [0.5])


def test_cosine_schedule():
    assert float(topt.cosine_schedule(0, base_lr=1.0, warmup=10,
                                      total=100)) == 0.0
    assert float(topt.cosine_schedule(10, base_lr=1.0, warmup=10,
                                      total=100)) == pytest.approx(1.0,
                                                                   abs=1e-5)
    assert float(topt.cosine_schedule(100, base_lr=1.0, warmup=10,
                                      total=100)) == pytest.approx(0.1,
                                                                   abs=1e-5)
