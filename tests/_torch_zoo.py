"""Shared helpers of the port's zoo-family parity tests: the JAX and port
configs of an arch's smoke variant, their params (the JAX init carried
over with ``params_from_numpy``), batches made from a seed with numpy, and
the token-by-token decode loops of both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import modules as jmod
from repro.models import zoo as jzoo
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import modules as tmod
from repro_torch.models import zoo

FULL_PARAMS = {"gemma-2b": 2_506_172_416, "glm4-9b": 9_399_951_360,
               "granite-20b": 28_167_493_632,
               "nemotron-4-15b": 15_628_376_064,
               "internvl2-1b": 631_658_368, "hubert-xlarge": 945_153_280,
               "granite-moe-1b-a400m": 1_385_481_216,
               "zamba2-1.2b": 1_170_473_856}
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CONSIST_TOL = dict(atol=2e-3, rtol=2e-3)


def cfgs(arch: str, **kw):
    """(port config, JAX config) of ``arch``'s smoke variant, replaced by
    ``kw`` (e.g. ``window=6``)."""
    ours = registry.smoke_variant(registry.get(arch)).replace(**kw)
    ref = jreg.smoke_variant(jreg.get(arch)).replace(**kw)
    return ours, ref


@functools.lru_cache(maxsize=None)
def params(arch: str, seed: int = 0):
    """The JAX smoke params of ``arch`` and the same values as tensors
    (the family's tree does not depend on window or capacity)."""
    _, jcfg = cfgs(arch)
    jp = jzoo.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jp)


def np_(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tokens(seed: int, B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def batches(cfg, seed: int, B: int, S: int, n_patches=None):
    """(JAX batch, port batch) of the family's inputs: frames (audio),
    tokens, and for a VLM ``n_patches`` patch embeddings (the config's by
    default) before the text."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        fr = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
        return {"frames": jnp.asarray(fr)}, {"frames": torch.as_tensor(fr)}
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok)}
    tb = {"tokens": torch.as_tensor(tok, dtype=torch.long)}
    if cfg.family == "vlm":
        n = cfg.n_patches if n_patches is None else n_patches
        pe = rng.normal(size=(B, n, cfg.frontend_dim)).astype(np.float32)
        jb["patch_embeds"] = jnp.asarray(pe)
        tb["patch_embeds"] = torch.as_tensor(pe)
    return jb, tb


def param_count_of_reference(arch: str) -> int:
    shapes = jax.eval_shape(lambda k: jzoo.init_params(k, jreg.get(arch)),
                            jax.random.PRNGKey(0))
    return jmod.param_count(shapes)


def param_count_of_port(arch: str) -> int:
    return tmod.param_count(zoo.init_params(None, registry.get(arch),
                                            device="meta"))


def tree_paths(tree, prefix=()):
    """{path: (shape, dtype name)} of a port param tree, paths as JAX's
    ``keystr``-free tuples of keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_paths(tree[k], prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def jax_tree_paths(tree) -> dict:
    return {tuple(p.key for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def serve_both(arch: str, steps: int, B: int = 2, seed: int = 1, **kw):
    """``steps`` decode steps of both packages from empty caches of
    ``steps`` slots: (JAX logits list, port logits list, JAX cache, port
    cache)."""
    cfg, jcfg = cfgs(arch, **kw)
    jp, tp = params(arch)
    tok = tokens(seed, B, steps, cfg.vocab_size)
    jc = jzoo.init_cache(jcfg, B, steps)
    tc = zoo.init_cache(cfg, B, steps, device="cpu")
    step = jax.jit(lambda c, tk, pos: jzoo.serve_step(jp, jcfg, c, tk, pos))
    lj, lt = [], []
    for t in range(steps):
        a, jc = step(jc, jnp.asarray(tok[:, t:t + 1]), jnp.full((B,), t))
        b, tc = zoo.serve_step(tp, cfg, tc,
                               torch.as_tensor(tok[:, t:t + 1],
                                               dtype=torch.long),
                               torch.full((B,), t))
        lj.append(a)
        lt.append(b)
    return lj, lt, jc, tc


def serve_against_forward(cfg, tp, B: int, S: int, slots: int, seed: int = 2):
    """The port against itself: (forward logits over S tokens, the logits
    of S ``serve_step`` calls from a cache of ``slots`` slots). A VLM's
    forward gets no patches, so both read the same text."""
    tok = torch.as_tensor(tokens(seed, B, S, cfg.vocab_size),
                          dtype=torch.long)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, 0, cfg.frontend_dim))
    full, _ = zoo.forward(tp, cfg, batch)
    cache = zoo.init_cache(cfg, B, slots, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = zoo.serve_step(tp, cfg, cache, tok[:, t:t + 1],
                                   torch.full((B,), t))
        outs.append(lg)
    return full, torch.stack(outs, 1)
