"""The PyTorch port's model zoo (hybrid family, Zamba2) against the JAX
package, on the CPU at the smoke variant's sizes: the JAX init params are
carried over with ``params_from_numpy``, inputs are made from a seed with
numpy, everything is fp32.

Tolerances: single blocks 2e-5; the whole smoke forward's logits 1e-4
(the two frameworks sum in another order over 2 Mamba2 layers and one
shared block); serve-vs-forward 2e-3, as tests/test_decode_consistency.py
holds the JAX package."""
import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import modules as jmod
from repro.models import ssm as jssm
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import modules as tmod
from repro_torch.models import ssm as tssm
from repro_torch.models import zoo

BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cfg(window=None):
    cfg = registry.smoke_variant(registry.get("zamba2-1.2b"))
    return cfg.with_window(window) if window else cfg


def _jcfg(window=None):
    cfg = jreg.smoke_variant(jreg.get("zamba2-1.2b"))
    return cfg.with_window(window) if window else cfg


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def zamba():
    """The JAX smoke params, and the same values as tensors."""
    jp = jzoo.init_params(jax.random.PRNGKey(0), _jcfg())
    return jp, params_from_numpy(jp)


# ---------------------------------------------------------------------------
# configs and modules
# ---------------------------------------------------------------------------

def test_config_and_smoke_variant_equal_reference():
    for ours, ref in ((registry.get("zamba2-1.2b"), jreg.get("zamba2-1.2b")),
                      (_cfg(), _jcfg())):
        assert ours.__dict__ == ref.__dict__


def test_full_param_count_equals_reference():
    cfg = registry.get("zamba2-1.2b")
    shapes = jax.eval_shape(lambda k: jzoo.init_params(k, jreg.get(cfg.name)),
                            jax.random.PRNGKey(0))
    ours = zoo.init_params(None, cfg, device="meta")
    assert tmod.param_count(ours) == jmod.param_count(shapes) == 1_170_473_856


def test_init_params_tree_matches_reference(zamba):
    jp, _ = zamba
    ours = zoo.init_params(torch.Generator().manual_seed(0), _cfg(),
                           device="cpu")
    theirs = jax.tree_util.tree_leaves_with_path(jp)
    mine = tmod.tree_leaves(ours)
    assert len(mine) == len(theirs)
    for t, (path, j) in zip(mine, theirs):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path


@pytest.mark.parametrize("name", ["silu", "gelu", "geglu_gelu", "relu2",
                                  "relu"])
def test_activations_match_reference(name):
    x = _x(1, (64,)) * 3
    np.testing.assert_allclose(
        _np(tmod.act_fn(name)(torch.as_tensor(x))),
        _np(jmod.act_fn(name)(jnp.asarray(x))), **BLOCK_TOL)


def test_rmsnorm_rope_mlp_match_reference():
    x = _x(2, (2, 5, 4, 16))
    scale = {"scale": _x(3, (16,))}
    for eps in (1e-6, 1e-5):
        np.testing.assert_allclose(
            _np(tmod.rmsnorm(params_from_numpy(scale), torch.as_tensor(x),
                             eps)),
            _np(jmod.rmsnorm(scale, jnp.asarray(x), eps)), **BLOCK_TOL)
    pos = np.arange(5)[None] + np.array([[0], [7]])
    np.testing.assert_allclose(
        _np(tmod.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 500.0)),
        _np(jmod.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)),
        **BLOCK_TOL)
    mp = jmod.init_mlp(jax.random.PRNGKey(4), 16, 24, True)
    np.testing.assert_allclose(
        _np(tmod.mlp_apply(params_from_numpy(mp), torch.as_tensor(x),
                           "gelu")),
        _np(jmod.mlp_apply(mp, jnp.asarray(x), "gelu")), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# Mamba2 and attention blocks
# ---------------------------------------------------------------------------

def _mamba_kw(cfg):
    return dict(d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim)


def test_mamba2_fwd_matches_reference(zamba):
    jp, tp = zamba
    cfg = _cfg()
    x = _x(5, (2, 48, cfg.d_model))
    fwd = jax.jit(lambda p, x: jssm.mamba2_fwd(p, x, chunk=16,
                                               **_mamba_kw(cfg)))
    want = fwd(jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mixer"]),
               jnp.asarray(x))
    got = tssm.mamba2_fwd(tmod.tree_index(tp["blocks"]["mixer"], 0),
                          torch.as_tensor(x), chunk=16, **_mamba_kw(cfg))
    np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)


def test_mamba2_step_matches_reference(zamba):
    jp, tp = zamba
    cfg = _cfg()
    jm = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["mixer"])
    tm = tmod.tree_index(tp["blocks"]["mixer"], 1)
    jc = jssm.init_mamba2_cache(2, cfg.d_model, **_mamba_kw(cfg))
    tc = tssm.init_mamba2_cache(2, cfg.d_model, **_mamba_kw(cfg))
    step = jax.jit(lambda c, x: jssm.mamba2_step(jm, c, x, **_mamba_kw(cfg)))
    for t in range(4):
        x = _x(10 + t, (2, 1, cfg.d_model))
        yj, jc = step(jc, jnp.asarray(x))
        yt, tc = tssm.mamba2_step(tm, tc, torch.as_tensor(x),
                                  **_mamba_kw(cfg))
        np.testing.assert_allclose(_np(yt), _np(yj), **BLOCK_TOL)
    for k in jc:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **BLOCK_TOL)


def _attn_kw(cfg, window):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=window)


@pytest.mark.parametrize("window", [None, 8])
def test_attention_fwd_matches_reference(zamba, window):
    jp, tp = zamba
    cfg = _cfg()
    x = _x(6, (2, 24, cfg.d_model))
    want = jattn.attention_fwd(jp["shared_attn"]["attn"], jnp.asarray(x),
                               **_attn_kw(cfg, window))
    got = tattn.attention_fwd(tp["shared_attn"]["attn"], torch.as_tensor(x),
                              **_attn_kw(cfg, window))
    np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)


@pytest.mark.parametrize("window,slots", [(None, 12), (5, 5)])
def test_attention_decode_matches_reference(zamba, window, slots):
    """Positional cache, and a ring buffer of ``window`` slots that wraps
    twice over 12 steps."""
    jp, tp = zamba
    cfg = _cfg()
    jc = jattn.init_kv_cache(2, slots, cfg.n_kv_heads, cfg.hd, jnp.float32)
    tc = tattn.init_kv_cache(2, slots, cfg.n_kv_heads, cfg.hd, torch.float32)
    step = jax.jit(lambda c, x, pos: jattn.attention_decode(
        jp["shared_attn"]["attn"], c, x, pos, **_attn_kw(cfg, window)))
    for t in range(12):
        x = _x(20 + t, (2, 1, cfg.d_model))
        pos = np.array([t, t], np.int32)
        yj, jc = step(jc, jnp.asarray(x), jnp.asarray(pos))
        yt, tc = tattn.attention_decode(tp["shared_attn"]["attn"], tc,
                                        torch.as_tensor(x),
                                        torch.as_tensor(pos, dtype=torch.long),
                                        **_attn_kw(cfg, window))
        np.testing.assert_allclose(_np(yt), _np(yj), **BLOCK_TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **BLOCK_TOL)


def test_sdpa_and_mask_bias_match_reference():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
               for _ in range(3))
    bj = jattn.make_mask_bias(6, 6, causal=True, window=3, q_offset=0)
    bt = tattn.make_mask_bias(6, 6, causal=True, window=3)
    np.testing.assert_array_equal(_np(bt), _np(bj))
    np.testing.assert_allclose(
        _np(tattn.sdpa(*map(torch.as_tensor, (q, k, v)), bt, 0.25)),
        _np(jattn.sdpa(*map(jnp.asarray, (q, k, v)), bj, 0.25)), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("window", [None, 8])
def test_forward_logits_match_reference(zamba, window):
    jp, tp = zamba
    tok = _tokens(0, 2, 32, _cfg().vocab_size)
    want, _ = jzoo.forward(jp, _jcfg(window), {"tokens": jnp.asarray(tok)})
    got, aux = zoo.forward(tp, _cfg(window),
                           {"tokens": torch.as_tensor(tok, dtype=torch.long)})
    assert got.shape == (2, 32, _cfg().padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    assert float(aux["load_balance_loss"]) == 0.0


def test_serve_steps_match_reference(zamba):
    """16 decode steps, logits and caches, port against the JAX package."""
    jp, tp = zamba
    cfg, jcfg = _cfg(), _jcfg()
    B, S = 2, 16
    tok = _tokens(1, B, S, cfg.vocab_size)
    jc = jzoo.init_cache(jcfg, B, S)
    tc = zoo.init_cache(cfg, B, S, device="cpu")
    step = jax.jit(lambda c, tk, pos: jzoo.serve_step(jp, jcfg, c, tk, pos))
    for t in range(S):
        lj, jc = step(jc, jnp.asarray(tok[:, t:t + 1]), jnp.full((B,), t))
        lt, tc = zoo.serve_step(tp, cfg, tc,
                                torch.as_tensor(tok[:, t:t + 1],
                                                dtype=torch.long),
                                torch.full((B,), t))
        np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4, rtol=1e-4)
    for group in ("mamba", "shared_attn"):
        for k in jc[group]:
            np.testing.assert_allclose(_np(tc[group][k]), _np(jc[group][k]),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 6])
def test_serve_matches_forward(zamba, window):
    """The port against itself: token-by-token decode (a ring cache of
    ``window`` slots when windowed) reproduces the forward's logits."""
    _, tp = zamba
    cfg = _cfg(window)
    B, S = 2, 16
    tok = torch.as_tensor(_tokens(2, B, S, cfg.vocab_size), dtype=torch.long)
    full, _ = zoo.forward(tp, cfg, {"tokens": tok})
    cache = zoo.init_cache(cfg, B, window or S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = zoo.serve_step(tp, cfg, cache, tok[:, t:t + 1],
                                   torch.full((B,), t))
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=2e-3,
                               rtol=2e-3)


def test_serve_step_leaves_its_cache_unchanged(zamba):
    _, tp = zamba
    cfg = _cfg()
    cache = zoo.init_cache(cfg, 1, 4, device="cpu")
    before = tmod.tree_map(torch.clone, cache)
    zoo.serve_step(tp, cfg, cache, torch.ones((1, 1), dtype=torch.long),
                   torch.zeros(1, dtype=torch.long))
    for a, b in zip(tmod.tree_leaves(cache), tmod.tree_leaves(before)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the rest of the zoo, and the serving CLI
# ---------------------------------------------------------------------------

def test_unported_archs_and_families_raise():
    """Every arch of the JAX package's registry resolves (DeepSeek-V3 and
    xLSTM-350M too); an unknown arch or family raises. Nothing of the zoo
    is left unported: a sharded KV cache (``kv_spec``, 16d-i) without a
    mesh to place it on is a ValueError, and training under a mesh (16d-ii)
    takes a ``FedMesh`` (another mesh is a TypeError) and a rank's
    ``state_specs`` blocks (``zoo.shard_state``; tests/test_torch_zoo_tp*
    and test_torch_zoo_train_tp* run both on gloo worlds). The training
    step (17f) runs on one device (tests/test_torch_train_*.py)."""
    from repro_torch.launch.mesh import FedMesh
    from repro_torch.sharding import specs as tspecs
    assert set(registry.ARCHS) == set(jreg.ARCHS)
    for arch in ("deepseek-v3-671b", "xlstm-350m"):
        assert registry.get(arch).__dict__ == jreg.get(arch).__dict__
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get("no-such-arch")
    assert not hasattr(zoo, "_ROADMAP_ITEM")
    state = zoo.init_train_state(torch.Generator().manual_seed(0), _cfg(),
                                 device="cpu")
    assert int(state["step"]) == 0
    mesh = FedMesh(group=None, rank=1, world=2, shape={"data": 1,
                                                       "model": 2},
                   backend="gloo", device=torch.device("cpu"))
    for arch in ("deepseek-v3-671b", "xlstm-350m"):
        cfg = registry.smoke_variant(registry.get(arch))
        tp = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        cache = zoo.init_cache(cfg, 1, 4, device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            zoo.serve_step(tp, cfg, cache,
                           torch.ones((1, 1), dtype=torch.long),
                           torch.zeros(1, dtype=torch.long),
                           kv_spec=("data", None))
        batch = {"tokens": torch.ones((1, 4), dtype=torch.long),
                 "labels": torch.ones((1, 4), dtype=torch.long)}
        whole = zoo.init_train_state(None, cfg, device="meta")
        blocks = zoo.shard_state(whole, cfg, mesh, zero=True)
        specs = tspecs.state_specs(whole, cfg, mp=2, zero=True)
        for key in ("params", "mu", "nu"):
            for (_, w), (_, b), (_, sp) in zip(
                    tspecs.spec_items(whole[key]),
                    tspecs.spec_items(blocks[key]),
                    tspecs.spec_items(specs[key])):
                assert tuple(b.shape) == tspecs.shard_shape(w.shape, sp,
                                                            mesh)
        assert blocks["params"]["embed"].shape[0] == cfg.padded_vocab // 2
        with pytest.raises(TypeError, match="FedMesh"):
            zoo.train_step(blocks, batch, cfg, mesh=object())
        with pytest.raises(TypeError, match="FedMesh"):
            zoo.loss_fn(tp, cfg, batch, mesh=object())
    with pytest.raises(ValueError):
        zoo.init_params(None, _cfg().replace(family="rnn"), device="meta")


def test_serve_cli_runs_on_cpu_and_prints_its_timing_line():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1.2b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen", "4", "--window", "4"], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("# served zamba2-1.2b: batch=2 prompt=8 gen=4")
    assert lines[1].startswith("prefill ") and "ms  decode " in lines[1]
    assert lines[1].endswith("tok/s)")


@pytest.mark.parametrize("arch", ["xlstm-350m", "deepseek-v3-671b"])
def test_serve_cli_runs_the_last_two_families_on_cpu(arch):
    """xLSTM's smoke variant decodes through its recurrent states,
    DeepSeek's through MLA's compressed cache and the MoE layer."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == f"# served {arch}: batch=2 prompt=8 gen=4 device=cpu"
    assert lines[1].startswith("prefill ") and lines[1].endswith("tok/s)")


@pytest.mark.parametrize("extra", [[], ["--window", "4"]])
def test_serve_cli_default_arch_is_gemma(extra):
    """No ``--arch``: gemma-2b, as the JAX launcher's default."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
         "4"] + extra, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == ("# served gemma-2b: batch=2 prompt=8 gen=4 "
                        "device=cpu")
    assert lines[1].startswith("prefill ") and lines[1].endswith("tok/s)")
