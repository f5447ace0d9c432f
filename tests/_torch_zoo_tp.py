"""Shared helpers of the zoo's tensor-parallel tests
(``tests/test_torch_zoo_tp*.py``, ``_specs.py``, ``_dryrun_mesh.py``): the
JAX package's runs of the archs the ranks are held to directly (Zamba2's
and Gemma's smoke variants from the JAX init, on the driver's numpy
inputs), the params file the ranks load them from, the reading of a
world's rank files, and the bytes the reference's specs imply."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import _torch_zoo_tp_driver as drv
from repro.configs import registry as jreg
from repro.models import zoo as jzoo
from repro.sharding import specs as jspecs
from repro_torch.sharding import specs

JAX_ARCHS = ("gemma-2b", "zamba2-1.2b")
TP_TOL = 1e-5          # a world of M ranks against mesh=None (relative to
                       # the larger of 1 and the values' largest magnitude)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(tree, prefix: str) -> dict:
    return {prefix + "/" + "/".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def jax_runs() -> tuple:
    """({arch/leaf: array} of the JAX init of JAX_ARCHS, {arch: {"logits",
    "step<t>"}}): ``zoo.forward`` on the driver's batch and ``STEPS``
    ``serve_step`` calls on its decode tokens, from an empty cache."""
    flat, runs = {}, {}
    for arch in JAX_ARCHS:
        jcfg = jreg.smoke_variant(jreg.get(arch))
        cfg = drv.config(arch)
        jp = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
        flat.update(_flat(jp, arch))
        inputs = {k: jnp.asarray(v.numpy()) for k, v in drv.batch(cfg).items()}
        logits, _ = jax.jit(lambda p, b: jzoo.forward(p, jcfg, b))(jp, inputs)
        out = {"logits": np.asarray(logits)}
        toks = drv.decode_tokens(cfg).numpy().astype(np.int32)
        cache = jzoo.init_cache(jcfg, drv.B, drv.STEPS)
        step = jax.jit(lambda p, c, t, pos: jzoo.serve_step(p, jcfg, c, t,
                                                            pos))
        for t in range(drv.STEPS):
            lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.full((drv.B,), t))
            out[f"step{t}"] = np.asarray(lg)
        runs[arch] = out
    return flat, runs


def write_params(path) -> str:
    np.savez(path, **jax_runs()[0])
    return str(path)


def rank_rows(world: int, model: int, rank: int) -> slice:
    """The batch rows of ``rank`` (its data slice's block of B)."""
    D = world // model
    d = rank // model
    return slice(d * drv.B // D, (d + 1) * drv.B // D)


def values(res: dict, name: str, kind: str) -> dict:
    """``{run/key: value}`` of a rank's ``<name>/<run>/<kind>/<key>``."""
    pre = name + "/"
    out = {}
    for k, v in res.items():
        if not k.startswith(pre):
            continue
        run, what, *rest = k[len(pre):].split("/")
        if what == kind:
            out["/".join([run] + rest)] = v
    return out


def jax_items(tree) -> dict:
    """{path names: tuple(spec)} of a JAX spec tree."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, P)):
        out[tuple(jspecs._path_names(path))] = tuple(s)
    return out


def leaf_shapes(tree, is_jax: bool) -> dict:
    """{path names: shape} of a JAX tree or a port one."""
    if is_jax:
        return {tuple(jspecs._path_names(p)): tuple(l.shape) for p, l in
                jax.tree_util.tree_leaves_with_path(tree)}
    return {tuple(n): tuple(l.shape) for n, l in specs.spec_items(tree)}


def implied_bytes(shapes: dict, spec_items: dict, mesh: dict, itemsize
                  ) -> int:
    """Rank 0's bytes of a tree placed by JAX specs: each dim divided by
    its axes' sizes, as ``NamedSharding.shard_shape`` reads them."""
    total = 0
    for path, shape in shapes.items():
        n = 1
        for d, e in zip(shape, spec_items[path]):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // math.prod(mesh[a] for a in axes)
        total += n * itemsize[path]
    return total
