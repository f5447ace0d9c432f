"""The port's dense family (Gemma-2B, GLM-4-9B, Granite-20B, Nemotron-4-15B)
against the JAX package, on the CPU at the reference's smoke variants (2
layers, d_model 256, fp32): the JAX init params are carried over with
``params_from_numpy``, inputs are made from a seed with numpy.

Tolerances: forward logits and 16 ``serve_step``s 1e-4 (the frameworks sum
in another order); serve against forward 2e-3, as
tests/test_decode_consistency.py holds the JAX package."""
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
from repro.configs import shapes as jshapes
from repro.models import zoo as jzoo
from repro_torch.configs import registry, shapes
from repro_torch.models import zoo

DENSE = ["gemma-2b", "glm4-9b", "granite-20b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", DENSE)
def test_config_and_smoke_variant_equal_reference(arch):
    assert registry.get(arch).__dict__ == jreg.get(arch).__dict__
    ours, ref = cfgs(arch)
    assert ours.__dict__ == ref.__dict__


@pytest.mark.parametrize("arch", DENSE)
def test_full_param_count_equals_reference(arch):
    assert (param_count_of_port(arch) == param_count_of_reference(arch)
            == FULL_PARAMS[arch])


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches_reference(arch):
    jp, _ = params(arch)
    cfg, _ = cfgs(arch)
    ours = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert tree_paths(ours) == jax_tree_paths(jp)
    # tied embeddings (Gemma): no lm_head
    assert (("lm_head",) in tree_paths(ours)) != cfg.tie_embeddings


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch):
    cfg, jcfg = cfgs(arch)
    jp, tp = params(arch)
    jb, tb = batches(cfg, 0, 2, 32)
    want, _ = jzoo.forward(jp, jcfg, jb)
    got, aux = zoo.forward(tp, cfg, tb)
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)
    assert float(aux["load_balance_loss"]) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_serve_steps_match_reference(arch):
    """16 decode steps, logits and the final caches."""
    lj, lt, jc, tc = serve_both(arch, 16)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)
    for k in jc:
        np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_matches_forward(arch):
    cfg, _ = cfgs(arch)
    _, tp = params(arch)
    full, dec = serve_against_forward(cfg, tp, 2, 16, 16)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)


def test_gemma_windowed_serve_matches_forward_and_reference():
    """A window of 6 over a 6-slot ring that wraps: decode reproduces the
    windowed forward (the reference's windowed test), and the port's ring
    cache equals the JAX package's step by step."""
    cfg, jcfg = cfgs("gemma-2b", window=6)
    jp, tp = params("gemma-2b")
    full, dec = serve_against_forward(cfg, tp, 1, 12, 6)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)
    jb, tb = batches(cfg, 3, 1, 12)
    np.testing.assert_allclose(np_(zoo.forward(tp, cfg, tb)[0]),
                               np_(jzoo.forward(jp, jcfg, jb)[0]),
                               **LOGIT_TOL)
    lj, lt, jc, tc = serve_both("gemma-2b", 12, B=1, window=6)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)


def test_gemma_embed_scale_is_rounded_to_the_activation_dtype():
    """bf16 at Gemma's d_model 2048: √2048 = 45.2548… is 45.25 in bf16,
    and the embeddings are scaled by that, as the JAX package does."""
    cfg, jcfg = cfgs("gemma-2b", d_model=2048, dtype="bfloat16")
    emb = np.random.default_rng(4).normal(
        size=(cfg.padded_vocab, 2048)).astype(np.float32)
    tok = np.arange(0, 512, 7, dtype=np.int32)[None]
    got, _ = zoo.embed_inputs({"embed": torch.as_tensor(emb)}, cfg,
                              {"tokens": torch.as_tensor(tok,
                                                         dtype=torch.long)})
    want, _ = jzoo.embed_inputs({"embed": jnp.asarray(emb)}, jcfg,
                                {"tokens": jnp.asarray(tok)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(got), np.asarray(want, np.float32))
    base = torch.as_tensor(emb).to(torch.bfloat16)[torch.as_tensor(tok)]
    assert torch.equal(got, base * 45.25)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_shape_tables_match_reference(arch):
    """``supported`` and ``config_for`` of every ported arch × shape equal
    the JAX package's; long_500k is the 8,192 window but for xLSTM."""
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW == 8192
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert shape.__dict__ == jshape.__dict__
        cfg, jcfg = registry.get(arch), jreg.get(arch)
        assert shapes.supported(cfg, shape) == jshapes.supported(jcfg, jshape)
        assert (shapes.config_for(cfg, shape).__dict__
                == jshapes.config_for(jcfg, jshape).__dict__)
    long = shapes.config_for(registry.get(arch), shapes.SHAPES["long_500k"])
    # xLSTM (the ssm family) keeps its O(1) state and takes no window
    want = None if registry.get(arch).family == "ssm" else 8192
    assert long.window == want and long.subquadratic


def test_kv_spec_other_than_none_raises():
    """``kv_spec`` places a cache on a mesh (ported: the slot-split decode,
    tests/test_torch_zoo_tp*.py): without ``mesh=`` it is a ValueError,
    and a spec that is not one layer's is refused."""
    cfg, _ = cfgs("gemma-2b")
    _, tp = params("gemma-2b")
    cache = zoo.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.ones((1, 1), dtype=torch.long)
    pos = torch.zeros(1, dtype=torch.long)
    zoo.serve_step(tp, cfg, cache, tok, pos, kv_spec=None)
    with pytest.raises(ValueError, match="mesh"):
        zoo.serve_step(tp, cfg, cache, tok, pos, kv_spec=("data", None))
    with pytest.raises(ValueError, match="one layer"):
        zoo._slot_split("model")
