"""The port's VLM (InternVL2-1B) and audio (HuBERT-XLarge) families against
the JAX package, on the CPU at the reference's smoke variants: the vision
projector before the text, text-only serving, the bidirectional encoder
with its frame front end and ``lm_head``, and its missing decode step.
Tolerances as tests/test_torch_zoo_dense.py's."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CONSIST_TOL, FULL_PARAMS, LOGIT_TOL, batches, cfgs,
                        jax_tree_paths, np_, param_count_of_port,
                        param_count_of_reference, params,
                        serve_against_forward, serve_both, tree_paths)
from repro.configs import registry as jreg
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.models import zoo

FRONTENDS = ["internvl2-1b", "hubert-xlarge"]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", FRONTENDS)
def test_config_and_smoke_variant_equal_reference(arch):
    assert registry.get(arch).__dict__ == jreg.get(arch).__dict__
    ours, theirs = cfgs(arch)
    assert ours.__dict__ == theirs.__dict__


@pytest.mark.parametrize("arch", FRONTENDS)
def test_full_param_count_equals_reference(arch):
    assert (param_count_of_port(arch) == param_count_of_reference(arch)
            == FULL_PARAMS[arch])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_init_params_tree_matches_reference(arch):
    jp, _ = params(arch)
    cfg, _ = cfgs(arch)
    ours = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert tree_paths(ours) == jax_tree_paths(jp)


@pytest.mark.parametrize("n_patches", [None, 0])
def test_vlm_forward_with_patch_embeddings_matches_reference(n_patches):
    """The projected patches (the config's 16, or none) come before the
    32 text tokens; the logits cover both."""
    cfg, jcfg = cfgs("internvl2-1b")
    jp, tp = params("internvl2-1b")
    jb, tb = batches(cfg, 0, 2, 32, n_patches=n_patches)
    want, _ = jzoo.forward(jp, jcfg, jb)
    got, _ = zoo.forward(tp, cfg, tb)
    n = cfg.n_patches if n_patches is None else n_patches
    assert got.shape == (2, n + 32, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)


def test_vlm_projector_uses_tanh_gelu():
    """``jax.nn.gelu`` is the tanh form: the erf form moves the logits."""
    cfg, _ = cfgs("internvl2-1b")
    _, tp = params("internvl2-1b")
    _, tb = batches(cfg, 0, 1, 4)
    x, _ = zoo.embed_inputs(tp, cfg, tb)
    proj = tp["projector"]
    pe = tb["patch_embeds"] @ proj["w1"]
    torch.testing.assert_close(
        x[:, :cfg.n_patches],
        torch.nn.functional.gelu(pe, approximate="tanh") @ proj["w2"])
    assert not torch.allclose(
        x[:, :cfg.n_patches], torch.nn.functional.gelu(pe) @ proj["w2"],
        atol=1e-7, rtol=0)


def test_vlm_text_serve_steps_match_reference():
    lj, lt, jc, tc = serve_both("internvl2-1b", 16)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np_(b), np_(a), **LOGIT_TOL)
    for k in jc:
        np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **LOGIT_TOL)


def test_vlm_text_serve_matches_forward():
    cfg, _ = cfgs("internvl2-1b")
    _, tp = params("internvl2-1b")
    full, dec = serve_against_forward(cfg, tp, 2, 16, 16)
    torch.testing.assert_close(dec, full, **CONSIST_TOL)


def test_audio_forward_matches_reference_and_is_bidirectional():
    cfg, jcfg = cfgs("hubert-xlarge")
    jp, tp = params("hubert-xlarge")
    assert not cfg.causal and "embed" not in tp and "lm_head" in tp
    jb, tb = batches(cfg, 0, 2, 32)
    want, _ = jzoo.forward(jp, jcfg, jb)
    got, _ = zoo.forward(tp, cfg, tb)
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)
    # bidirectional: changing the last frame moves the first position
    frames = tb["frames"].clone()
    frames[:, -1] += 1.0
    moved, _ = zoo.forward(tp, cfg, {"frames": frames})
    assert not torch.allclose(moved[:, 0], got[:, 0])


def test_audio_has_no_decode_step():
    cfg, _ = cfgs("hubert-xlarge")
    _, tp = params("hubert-xlarge")
    assert not cfg.decode_supported
    with pytest.raises(ValueError, match="encoder-only"):
        zoo.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        zoo.serve_step(tp, cfg, {}, torch.ones((1, 1), dtype=torch.long),
                       torch.zeros(1, dtype=torch.long))


def test_audio_serve_cli_says_encoder_only_and_exits_1():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hubert-xlarge", "--smoke", "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.strip() == "hubert-xlarge is encoder-only: no decode step"
