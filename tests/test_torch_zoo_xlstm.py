"""The port's xLSTM (the zoo's ``ssm`` family, xLSTM-350M) against the JAX
package, on the CPU at the reference's smoke variant (an mLSTM and an
sLSTM block, d_model 256, 4 heads, chunk 8, fp32): the JAX init params
are carried over with ``params_from_numpy``, inputs are made from a seed
with numpy.

Tolerances: cells, scans, the chunkwise form and single blocks 1e-5 in
fp32; the chunkwise form in bf16 2e-2 on h (one bf16 rounding of the
output) and 1e-5 on its fp32 carry, which rounds k's scale to bf16 as
the reference does; chunkwise against recurrent 1e-4 (the reference's
own claim); the model's logits and 16 serve steps 1e-4; serve against
forward 2e-3."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CONSIST_TOL, LOGIT_TOL, batches, cfgs, np_, params,
                        serve_against_forward, serve_both)
from repro.configs import registry as jreg
from repro.models import modules as jmod
from repro.models import xlstm as jx
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import modules as tmod
from repro_torch.models import xlstm as tx
from repro_torch.models import zoo

ARCH = "xlstm-350m"
TOL = dict(atol=1e-5, rtol=1e-5)
IMPL_TOL = dict(atol=1e-4, rtol=1e-4)
D, H = 256, 4                     # the smoke variant's widths
DI = 2 * D                        # mLSTM's inner width (proj factor 2)
P = DI // H


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _block(kind: str):
    """One smoke-width block of the JAX package, and as tensors."""
    key = jax.random.PRNGKey(7)
    jp = (jx.init_slstm(key, D, H) if kind == "s"
          else jx.init_mlstm(key, D, H, proj_factor=2))
    return jp, params_from_numpy(jp)


def _paths(tree, prefix=()):
    """{path: shape} of a tree of dicts and lists (list entries by
    index), for either package."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _gates(seed, B, S):
    """Raw i, f gate logits (B, S, H): i around 0, f around 4 (slow
    forgetting, as b_if starts it)."""
    return (_x(seed, (B, S, H)), _x(seed + 1, (B, S, H)) + 4.0)


def test_config_and_smoke_variant_equal_reference():
    assert registry.get(ARCH).__dict__ == jreg.get(ARCH).__dict__
    ours, ref = cfgs(ARCH)
    assert ours.__dict__ == ref.__dict__
    full = registry.get(ARCH)
    assert full.xlstm_pattern.count("s") == 4 and [
        i for i, k in enumerate(full.xlstm_pattern) if k == "s"] == [
        5, 11, 17, 23]


def test_param_count_on_meta_equals_reference():
    shapes = jax.eval_shape(lambda k: jzoo.init_params(k, jreg.get(ARCH)),
                            jax.random.PRNGKey(0))
    ours = zoo.init_params(None, registry.get(ARCH), device="meta")
    assert tmod.param_count(ours) == jmod.param_count(shapes) == 519_001_248


def test_init_params_tree_matches_reference():
    """``blocks_list`` is a list of an mLSTM and an sLSTM dict; mLSTM's
    gate projection and bias are fp32 whatever ``param_dtype``."""
    jp, _ = params(ARCH)
    cfg, _ = cfgs(ARCH)
    ours = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert isinstance(ours["blocks_list"], list)
    assert _paths(ours) == _paths(jp)
    bf = zoo.init_params(None, cfg.replace(param_dtype="bfloat16"),
                         device="meta")
    m = bf["blocks_list"][0]
    assert m["wq"].dtype == torch.bfloat16
    assert m["w_if"].dtype == m["b_if"].dtype == torch.float32
    torch.testing.assert_close(
        zoo.init_params(torch.Generator().manual_seed(0), cfg,
                        device="cpu")["blocks_list"][0]["b_if"],
        torch.tensor([0.0, 0, 0, 0, 3, 4, 5, 6]))


def test_convert_keeps_lists_in_order():
    jp, tp = params(ARCH)
    assert isinstance(tp["blocks_list"], list)
    assert sorted(tp["blocks_list"][1]) == sorted(jp["blocks_list"][1])
    out = params_to_numpy(params_from_numpy(params_to_numpy(tp)))
    assert isinstance(out["blocks_list"], list)
    np.testing.assert_array_equal(out["blocks_list"][1]["r"],
                                  np.asarray(jp["blocks_list"][1]["r"]))


def test_layernorm_matches_reference():
    x = _x(0, (3, 5, 64), scale=3.0) + 1.5
    jp = {"scale": jnp.asarray(_x(1, (64,))),
          "bias": jnp.asarray(_x(2, (64,)))}
    want = jmod.layernorm(jp, jnp.asarray(x))
    got = tmod.layernorm(params_from_numpy(jp), torch.as_tensor(x))
    np.testing.assert_allclose(np_(got), np_(want), **TOL)
    assert tmod.init_layernorm(8)["bias"].abs().sum() == 0


def test_slstm_cell_matches_reference():
    jp, tp = _block("s")
    B = 3
    carry = (_x(1, (B, D)), _x(2, (B, D)), np.abs(_x(3, (B, D))) + 0.5,
             _x(4, (B, D)))
    xt = _x(5, (B, D))
    (jc, jh) = jx.slstm_cell(jp, tuple(map(jnp.asarray, carry)),
                             jnp.asarray(xt), H)
    (tc, th) = tx.slstm_cell(tp, tuple(map(torch.as_tensor, carry)),
                             torch.as_tensor(xt), H)
    np.testing.assert_allclose(np_(th), np_(jh), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


def test_slstm_scan_and_block_match_reference():
    jp, tp = _block("s")
    x = _x(6, (2, 20, D))
    jh, jc = jx.slstm_scan(jp, jnp.asarray(x), H, chunk=8)
    th, tc = tx.slstm_scan(tp, torch.as_tensor(x), H, chunk=8)
    np.testing.assert_allclose(np_(th), np_(jh), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)
    np.testing.assert_allclose(
        np_(tx.slstm_block_fwd(tp, torch.as_tensor(x), n_heads=H, chunk=8)),
        np_(jx.slstm_block_fwd(jp, jnp.asarray(x), n_heads=H, chunk=8)),
        **TOL)


def test_mlstm_cell_matches_reference():
    B = 2
    C = _x(1, (B, H, P, P), 0.1)
    n = _x(2, (B, H, P), 0.1)
    m = _x(3, (B, H))
    q, k, v = (_x(s, (B, H, P)) for s in (4, 5, 6))
    i_r, f_r = _x(7, (B, H)), _x(8, (B, H)) + 3.0
    args = ((C, n, m), (q, k, v, i_r, f_r))
    jc, jh = jx.mlstm_cell(*jax.tree_util.tree_map(jnp.asarray, args))
    tc, th = tx.mlstm_cell(*tmod.tree_map(torch.as_tensor, args))
    np.testing.assert_allclose(np_(th), np_(jh), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


@pytest.mark.parametrize("S", [16, 20], ids=["S16", "S20-chunk-shrinks"])
def test_mlstm_scan_matches_reference(S):
    """The recurrent scan; at S = 20 the reference shrinks its chunk 8 to
    a divisor (5), which changes no value."""
    jp, tp = _block("m")
    x = _x(9, (2, S, DI), 0.5)
    jh, jc = jx.mlstm_scan(jnp.asarray(x), jp, H, chunk=8)
    th, tc = tx.mlstm_scan(torch.as_tensor(x), tp, H, chunk=8)
    np.testing.assert_allclose(np_(th), np_(jh), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


def _qkv(seed, B, S):
    return tuple(_x(seed + i, (B, S, H, P)) for i in range(3))


def test_mlstm_chunkwise_matches_reference_fp32():
    q, k, v = _qkv(20, 2, 32)
    i_r, f_r = _gates(30, 2, 32)
    jh, jc = jx.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, i_r, f_r)), 8)
    th, tc = tx.mlstm_chunkwise(*map(torch.as_tensor, (q, k, v, i_r, f_r)),
                                8)
    np.testing.assert_allclose(np_(th), np_(jh), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


def test_mlstm_chunkwise_bf16_rounds_k_scale_as_reference(monkeypatch):
    """bf16 q, k, v: h within one bf16 rounding, and the fp32 carry within
    1e-5 of the reference's, which scales k by 1/√P rounded to bf16 (at
    xLSTM-350M's P = 512: 0.0441895, not 0.0441942). The control: with
    the scale left in fp32 the carry misses the reference's."""
    assert tx.k_scale(512, torch.bfloat16) == pytest.approx(0.0441895,
                                                            abs=1e-7)
    assert tx.k_scale(512, torch.float32) == pytest.approx(512 ** -0.5)
    q, k, v = _qkv(40, 2, 32)
    i_r, f_r = _gates(50, 2, 32)
    jh, jc = jx.mlstm_chunkwise(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                jnp.asarray(i_r), jnp.asarray(f_r), 8)
    args = tuple(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)) + (
        torch.as_tensor(i_r), torch.as_tensor(f_r), 8)
    th, tc = tx.mlstm_chunkwise(*args)
    assert th.dtype == torch.bfloat16 and tc[0].dtype == torch.float32
    np.testing.assert_allclose(np_(th), np.asarray(jh, np.float32),
                               atol=2e-2, rtol=2e-2)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)
    monkeypatch.setattr(tx, "k_scale", lambda P, dtype: 1.0 / P ** 0.5)
    _, unrounded = tx.mlstm_chunkwise(*args)
    assert not np.allclose(np_(unrounded[0]), np_(jc[0]), **TOL)


def test_mlstm_chunkwise_needs_s_a_multiple_of_the_chunk():
    q, k, v = _qkv(60, 1, 20)
    i_r, f_r = _gates(70, 1, 20)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tx.mlstm_chunkwise(*map(torch.as_tensor, (q, k, v, i_r, f_r)), 8)
    cfg, _ = cfgs(ARCH, mlstm_impl="chunkwise")
    _, tp = params(ARCH)
    _, tb = batches(cfg, 0, 1, 20)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        zoo.forward(tp, cfg, tb)


@pytest.mark.parametrize("impl", ["recurrent", "chunkwise"])
def test_mlstm_block_matches_reference(impl):
    jp, tp = _block("m")
    x = _x(11, (2, 32, D))
    want = jx.mlstm_block_fwd(jp, jnp.asarray(x), n_heads=H, chunk=8,
                              impl=impl)
    got = tx.mlstm_block_fwd(tp, torch.as_tensor(x), n_heads=H, chunk=8,
                             impl=impl)
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def test_chunkwise_matches_recurrent():
    """The port's two mLSTM forms on one block, 32 steps, 4 chunks."""
    _, tp = _block("m")
    x = torch.as_tensor(_x(12, (2, 32, D)))
    rec = tx.mlstm_block_fwd(tp, x, n_heads=H, chunk=8, impl="recurrent")
    chk = tx.mlstm_block_fwd(tp, x, n_heads=H, chunk=8, impl="chunkwise")
    torch.testing.assert_close(chk, rec, **IMPL_TOL)


@pytest.mark.parametrize("kind", ["s", "m"])
def test_block_steps_match_their_forwards(kind):
    """16 decode steps of one block from its empty cache against the
    block's forward over the same 16 inputs (port and reference), and the
    final cache against the reference's."""
    jp, tp = _block(kind)
    B, S = 2, 16
    x = _x(13, (B, S, D))
    if kind == "s":
        fwd = tx.slstm_block_fwd(tp, torch.as_tensor(x), n_heads=H)
        tc = tx.init_slstm_cache(B, D, torch.float32)
        jc = jx.init_slstm_cache(B, D)
        tstep = lambda c, xt: tx.slstm_block_step(  # noqa: E731
            tp, c, xt, n_heads=H)
        jstep = jax.jit(lambda c, xt: jx.slstm_block_step(jp, c, xt,
                                                          n_heads=H))
    else:
        fwd = tx.mlstm_block_fwd(tp, torch.as_tensor(x), n_heads=H)
        tc = tx.init_mlstm_cache(B, D, H)
        jc = jx.init_mlstm_cache(B, D, H)
        tstep = lambda c, xt: tx.mlstm_block_step(  # noqa: E731
            tp, c, xt, n_heads=H)
        jstep = jax.jit(lambda c, xt: jx.mlstm_block_step(jp, c, xt,
                                                          n_heads=H))
    outs = []
    for t in range(S):
        y, tc = tstep(tc, torch.as_tensor(x[:, t:t + 1]))
        yj, jc = jstep(jc, jnp.asarray(x[:, t:t + 1]))
        np.testing.assert_allclose(np_(y), np_(yj), **TOL)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), fwd, **TOL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **TOL)


@pytest.mark.parametrize("impl", ["recurrent", "chunkwise"])
def test_forward_logits_match_reference(impl):
    cfg, jcfg = cfgs(ARCH, mlstm_impl=impl)
    jp, tp = params(ARCH)
    jb, tb = batches(cfg, 0, 2, 32)
    want, waux = jzoo.forward(jp, jcfg, jb, return_hidden=True)
    got, aux = zoo.forward(tp, cfg, tb, return_hidden=True)
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)
    np.testing.assert_allclose(np_(aux["hidden"]), np_(waux["hidden"]),
                               **LOGIT_TOL)
    assert float(aux["load_balance_loss"]) == 0.0


def test_scan_units_gives_the_same_logits():
    """``xlstm_scan_units`` over a period-2 pattern of 4 layers: the port's
    loop over units is its loop over layers (equal logits), and both hold
    to the reference's unit scan."""
    kw = dict(n_layers=4, xlstm_pattern=("m", "s") * 2)
    assert zoo._pattern_period(kw["xlstm_pattern"]) == 2
    assert zoo._pattern_period(("m", "m", "s")) == 3
    cfg, jcfg = cfgs(ARCH, **kw)
    jp = jzoo.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jp)
    jb, tb = batches(cfg, 1, 2, 16)
    off = zoo.forward(tp, cfg, tb)[0]
    on = zoo.forward(tp, cfg.replace(xlstm_scan_units=True), tb)[0]
    assert torch.equal(on, off)
    want = jzoo.forward(jp, jcfg.replace(xlstm_scan_units=True), jb)[0]
    np.testing.assert_allclose(np_(on), np_(want), **LOGIT_TOL)


def test_serve_steps_match_reference():
    """16 decode steps, logits and every layer's final state."""
    lj, lt, jc, tc = serve_both(ARCH, 16)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)
    assert list(tc) == ["xlstm"] and len(tc["xlstm"]) == 2
    for c_t, c_j in zip(tc["xlstm"], jc["xlstm"]):
        assert sorted(c_t) == sorted(c_j)
        for k in c_j:
            np.testing.assert_allclose(np_(c_t[k]), np_(c_j[k]), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["recurrent", "chunkwise"])
def test_serve_matches_forward(impl):
    cfg, _ = cfgs(ARCH, mlstm_impl=impl)
    _, tp = params(ARCH)
    full, dec = serve_against_forward(cfg, tp, 2, 16, 16)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)


def test_serve_step_leaves_its_cache_unchanged():
    cfg, _ = cfgs(ARCH)
    _, tp = params(ARCH)
    cache = zoo.init_cache(cfg, 1, 4, device="cpu")
    _, cache = zoo.serve_step(tp, cfg, cache, torch.ones((1, 1),
                                                         dtype=torch.long),
                              torch.zeros(1, dtype=torch.long))
    before = tmod.tree_map(torch.clone, cache)
    zoo.serve_step(tp, cfg, cache, torch.ones((1, 1), dtype=torch.long),
                   torch.ones(1, dtype=torch.long))
    for a, b in zip(tmod.tree_leaves(cache), tmod.tree_leaves(before)):
        assert torch.equal(a, b)
