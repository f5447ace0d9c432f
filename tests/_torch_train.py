"""Shared helpers of the port's LM-training parity tests: the JAX
``init_train_state`` of an arch's smoke variant carried across with
``train_state_from_numpy``, one batch made from a seed with numpy and fed to
both packages, the loss, the gradient of every leaf and three AdamW steps
of each package."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_zoo import cfgs
from repro.models import zoo as jzoo
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves

B, S = 2, 16                   # S: a multiple of every smoke variant's chunk


def train_batches(cfg, seed: int = 3):
    """(JAX batch, port batch): tokens and next-token labels of B × S, with
    a few labels set to −1 (masked), plus the family's frames or patch
    embeddings (a VLM's labels cover its text only)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1
    labels[1, -1] = -1
    jb = {"tokens": tok[:, :-1], "labels": labels}
    if cfg.family == "audio":
        jb["frames"] = rng.normal(size=(B, S, cfg.frontend_dim)).astype(
            np.float32)
    elif cfg.family == "vlm":
        jb["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    tb = {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                             else None) for k, v in jb.items()}
    return {k: jnp.asarray(v) for k, v in jb.items()}, tb


@functools.lru_cache(maxsize=None)
def jax_state(arch: str, **kw):
    """The JAX smoke config's ``init_train_state`` from key 0, as numpy."""
    _, jcfg = cfgs(arch, **kw)
    st = jzoo.init_train_state(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(np.asarray, st)


def port_state(arch: str, **kw):
    """A fresh port train state equal to ``jax_state(arch, **kw)``."""
    return train_state_from_numpy(jax_state(arch, **kw))


def leaves_np(tree) -> list:
    """Leaves in JAX's order (dict keys sorted, lists in order) as numpy."""
    return [np.asarray(a.detach().float().numpy() if isinstance(
        a, torch.Tensor) else a, dtype=np.float32)
            for a in tree_leaves(tree)]


def jax_leaves(tree) -> list:
    return [np.asarray(a, dtype=np.float32)
            for a in jax.tree_util.tree_leaves(tree)]


def jax_loss_and_grads(arch: str, **kw):
    """(loss, metrics, grads as leaves) of the JAX package's ``loss_fn``."""
    _, jcfg = cfgs(arch, **kw)
    jb, _ = train_batches(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jax_state(arch, **kw)[
        "params"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(p, jcfg, jb), has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        jax_leaves(grads)


def port_loss_and_grads(arch: str, remat=None, **kw):
    """(loss, metrics, grads as leaves) of the port's ``loss_fn`` on the
    same params and batch; ``remat`` overrides the config's."""
    cfg, _ = cfgs(arch, **kw)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    _, tb = train_batches(cfg)
    params = port_state(arch, **kw)["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = zoo.loss_fn(params, cfg, tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, \
        [g.float().numpy() for g in grads]


def jax_steps(arch: str, steps: int = 3, **kw):
    """The JAX state after ``steps`` ``train_step``s on the same batch."""
    _, jcfg = cfgs(arch, **kw)
    jb, _ = train_batches(jcfg)
    st = jax.tree_util.tree_map(jnp.asarray, jax_state(arch, **kw))
    step = jax.jit(lambda s: jzoo.train_step(s, jb, jcfg))
    losses = []
    for _ in range(steps):
        st, m = step(st)
        losses.append(float(m["loss"]))
    return st, losses


def port_steps(arch: str, steps: int = 3, **kw):
    cfg, _ = cfgs(arch, **kw)
    _, tb = train_batches(cfg)
    st = port_state(arch, **kw)
    losses = []
    for _ in range(steps):
        st, m = zoo.train_step(st, tb, cfg)
        losses.append(float(m["loss"]))
    return st, losses


def max_rel(got: list, want: list) -> float:
    """The largest |got − want| of any leaf over that leaf's largest
    |want| (1 where the leaf is all zero)."""
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
        worst = max(worst, float(np.abs(g - w).max()) / scale
                    if w.size else 0.0)
    return worst


def check_loss_and_grads(arch: str, grad_tol: float, **kw):
    """The port's loss and metrics within 1e-4 of the JAX ``loss_fn``'s,
    every gradient leaf within ``grad_tol`` of the leaf's largest
    ``jax.grad`` magnitude (``max_rel``)."""
    jl, jm, jg = jax_loss_and_grads(arch, **kw)
    pl, pm, pg = port_loss_and_grads(arch, **kw)
    assert abs(pl - jl) <= 1e-4
    assert set(pm) == set(jm)
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 1e-4, k
    assert max_rel(pg, jg) <= grad_tol


def leaf_fro(got: list, want: list) -> float:
    """The largest ||got − want|| / ||want|| of any leaf (Frobenius)."""
    return max(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
               for g, w in zip(got, want))


def check_three_steps(arch: str, tol: dict, **kw):
    """Three ``train_step``s of both packages from the same state on the
    same batch: ``step`` equal; each step's loss within ``tol["loss"]``
    (absolute); params, ``mu`` and ``nu`` leaf by leaf within ``tol[key]``
    (``leaf_fro``). AdamW's first update is about lr·sign(g), so an
    element whose gradient is at the level of fp32 rounding may step
    either way: the same arithmetic in the JAX package, jitted against
    op by op, differs from itself by as much (the files state it)."""
    js, jls = jax_steps(arch, **kw)
    ps, pls = port_steps(arch, **kw)
    assert int(ps["step"]) == int(js["step"]) == 3
    assert ps["step"].dtype == torch.int32
    for a, b in zip(pls, jls):
        assert abs(a - b) <= tol["loss"]
    for key in ("params", "mu", "nu"):
        got, want = leaves_np(ps[key]), jax_leaves(js[key])
        assert [g.shape for g in got] == [w.shape for w in want]
        assert leaf_fro(got, want) <= tol[key], key
