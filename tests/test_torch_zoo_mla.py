"""The port's MLA attention, DeepSeek-V3 and its MTP head against the JAX
package, on the CPU at the reference's smoke variant (2 layers, d_model
256, 4 heads, q_rank 64, kv_rank 32, qk_nope 32, qk_rope 16, v 32, 4
experts, fp32): the JAX init params are carried over with
``params_from_numpy``, inputs are made from a seed with numpy.

Tolerances: ``mla_fwd`` and ``mla_decode`` 1e-5 (one layer, sums in
another order); the model's logits, ``mtp_logits`` and 16 serve steps
1e-4; serve against forward 2e-3 (the absorbed decode is not the
forward's arithmetic), at ``capacity_factor=100`` so that the MoE layer
drops no token in either."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CONSIST_TOL, LOGIT_TOL, batches, cfgs,
                        jax_tree_paths, np_, params, serve_against_forward,
                        serve_both, tree_paths)
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import modules as jmod
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import modules as tmod
from repro_torch.models import zoo

ARCH = "deepseek-v3-671b"
MLA_TOL = dict(atol=1e-5, rtol=1e-5)
# the published widths in full, and the cut chip_smoke.py runs on one card
COUNTS = {"full": ({}, 703_797_812_224),
          "cut": (dict(n_layers=3, n_experts=16, mtp=True), 5_013_474_304)}


def _mla_kw(cfg):
    return dict(n_heads=cfg.n_heads, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                v_dim=cfg.v_head_dim, kv_rank=cfg.kv_rank,
                rope_theta=cfg.rope_theta)


@functools.lru_cache(maxsize=None)
def _mla_params():
    """One smoke-width MLA layer of the JAX package, and as tensors."""
    cfg, _ = cfgs(ARCH)
    jp = jattn.init_mla(jax.random.PRNGKey(3), cfg.d_model, cfg.n_heads,
                        q_rank=cfg.q_rank, kv_rank=cfg.kv_rank,
                        qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                        v_dim=cfg.v_head_dim)
    return jp, params_from_numpy(jp)


@functools.lru_cache(maxsize=None)
def _mtp_params():
    """The smoke variant with the MTP head (DeepSeek's config leaves
    ``mtp`` off; the cut on the card turns it on)."""
    _, jcfg = cfgs(ARCH, mtp=True)
    jp = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jp)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_config_and_smoke_variant_equal_reference():
    assert registry.get(ARCH).__dict__ == jreg.get(ARCH).__dict__
    ours, ref = cfgs(ARCH)
    assert ours.__dict__ == ref.__dict__
    assert ours.mla and (ours.q_rank, ours.kv_rank, ours.qk_nope,
                         ours.qk_rope, ours.v_head_dim) == (64, 32, 32, 16, 32)


@pytest.mark.parametrize("which", sorted(COUNTS))
def test_param_count_on_meta_equals_reference(which):
    kw, want = COUNTS[which]
    shapes = jax.eval_shape(
        lambda k: jzoo.init_params(k, jreg.get(ARCH).replace(**kw)),
        jax.random.PRNGKey(0))
    ours = zoo.init_params(None, registry.get(ARCH).replace(**kw),
                           device="meta")
    assert tmod.param_count(ours) == jmod.param_count(shapes) == want


def test_init_params_tree_matches_reference():
    """MLA's eight leaves in every block, and the MTP head's dense block
    with d_ff = max(moe_d_ff, d_ff)."""
    jp, _ = _mtp_params()
    cfg, _ = cfgs(ARCH, mtp=True)
    ours = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert tree_paths(ours) == jax_tree_paths(jp)
    assert ours["blocks"]["attn"]["w_uk"].shape == (2, 32, 4 * 32)
    assert ours["mtp"]["block"]["mlp"]["w_up"].shape == (256, 512)


@pytest.mark.parametrize("causal,window,q_chunk", [
    (True, None, None), (True, 6, None), (True, None, 8), (True, 6, 8),
    (False, None, None)],
    ids=["causal", "window6", "q_chunk8", "window6-q_chunk8", "bidirectional"])
def test_mla_fwd_matches_reference(causal, window, q_chunk):
    cfg, _ = cfgs(ARCH)
    jp, tp = _mla_params()
    x = _x(1, (2, 32, cfg.d_model))
    kw = dict(_mla_kw(cfg), causal=causal, window=window, q_chunk=q_chunk)
    want = jattn.mla_fwd(jp, jnp.asarray(x), **kw)
    got = tattn.mla_fwd(tp, torch.as_tensor(x), **kw)
    np.testing.assert_allclose(np_(got), np_(want), **MLA_TOL)


def test_mla_fwd_q_chunk_equals_unchunked_and_must_divide_s():
    cfg, _ = cfgs(ARCH)
    _, tp = _mla_params()
    x = torch.as_tensor(_x(2, (1, 32, cfg.d_model)))
    full = tattn.mla_fwd(tp, x, **_mla_kw(cfg))
    torch.testing.assert_close(tattn.mla_fwd(tp, x, q_chunk=8,
                                             **_mla_kw(cfg)), full,
                               **MLA_TOL)
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        tattn.mla_fwd(tp, x, q_chunk=12, **_mla_kw(cfg))


@pytest.mark.parametrize("window,slots", [(None, 16), (6, 6)],
                         ids=["positional", "ring6"])
def test_mla_decode_matches_reference(window, slots):
    """16 absorbed-matrix decode steps from an empty compressed cache: y
    and both cache leaves every step (with a window the 6-slot ring wraps
    twice)."""
    cfg, _ = cfgs(ARCH)
    jp, tp = _mla_params()
    B = 2
    jc = jattn.init_mla_cache(B, slots, cfg.kv_rank, cfg.qk_rope,
                              jnp.float32)
    tc = tattn.init_mla_cache(B, slots, cfg.kv_rank, cfg.qk_rope,
                              torch.float32)
    assert tc["c_kv"].shape == (B, slots, 32) and tc["k_pe"].shape == (
        B, slots, 16)
    step = jax.jit(lambda c, x, pos: jattn.mla_decode(
        jp, c, x, pos, window=window, **_mla_kw(cfg)))
    for t in range(16):
        x = _x(10 + t, (B, 1, cfg.d_model))
        yj, jc = step(jc, jnp.asarray(x), jnp.full((B,), t))
        yt, tc = tattn.mla_decode(tp, tc, torch.as_tensor(x),
                                  torch.full((B,), t), window=window,
                                  **_mla_kw(cfg))
        np.testing.assert_allclose(np_(yt), np_(yj), **MLA_TOL)
        for k in ("c_kv", "k_pe"):
            np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **MLA_TOL)


def test_forward_logits_and_aux_match_reference():
    cfg, jcfg = cfgs(ARCH)
    jp, tp = params(ARCH)
    jb, tb = batches(cfg, 0, 2, 32)
    want, waux = jzoo.forward(jp, jcfg, jb, return_hidden=True)
    got, aux = zoo.forward(tp, cfg, tb, return_hidden=True)
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)
    for k in ("hidden", "load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(np_(aux[k]), np_(waux[k]), **LOGIT_TOL)


def test_forward_with_q_chunk_matches_reference():
    cfg, jcfg = cfgs(ARCH, attn_q_chunk=8)
    jp, tp = params(ARCH)
    jb, tb = batches(cfg, 4, 1, 32)
    np.testing.assert_allclose(np_(zoo.forward(tp, cfg, tb)[0]),
                               np_(jzoo.forward(jp, jcfg, jb)[0]),
                               **LOGIT_TOL)


def test_mtp_logits_match_reference():
    """From each package's own ``forward(return_hidden=True)``: (B, S−1,
    V) logits for the targets two ahead."""
    cfg, jcfg = cfgs(ARCH, mtp=True)
    jp, tp = _mtp_params()
    jb, tb = batches(cfg, 5, 2, 32)
    _, jaux = jzoo.forward(jp, jcfg, jb, return_hidden=True)
    _, taux = zoo.forward(tp, cfg, tb, return_hidden=True)
    want = jzoo.mtp_logits(jp, jcfg, jaux["hidden"], jb["tokens"])
    got = zoo.mtp_logits(tp, cfg, taux["hidden"], tb["tokens"])
    assert got.shape == (2, 31, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_serve_steps_match_reference(window):
    """16 decode steps, logits and the final compressed caches (a 6-slot
    ring with a window)."""
    lj, lt, jc, tc = serve_both(ARCH, 16, window=window)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)
    assert sorted(tc) == ["c_kv", "k_pe"]
    for k in jc:
        np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **LOGIT_TOL)


@pytest.mark.parametrize("window,slots", [(None, 16), (6, 6)],
                         ids=["positional", "ring6"])
def test_serve_matches_forward(window, slots):
    cfg, _ = cfgs(ARCH, capacity_factor=100.0)
    if window:
        cfg = cfg.with_window(window)
    _, tp = params(ARCH)
    full, dec = serve_against_forward(cfg, tp, 2, 16, slots)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)
