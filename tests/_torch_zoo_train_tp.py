"""Shared helpers of the zoo's tensor-parallel training tests
(``tests/test_torch_zoo_train_tp*.py``): the tolerances, the reading of a
world's rank files, the JAX package's train state of the archs the ranks
are held to directly (Zamba2's and Gemma's smoke variants, through
``tests/_torch_train.py``) and the whole leaves assembled from the ranks'
blocks by their specs.

Tolerances. A world of M ranks against the port without a mesh: the loss
and every leaf's gradient (gathered, ``max_rel``) within ``TP_TOL``
(measured ≤ 2e-6: fp32 sums over the rank's columns, heads or vocab
block, then over the group); each of three steps' loss within
``STEP_LOSS_TOL``; each leaf of ``mu`` and ``nu`` within ``STATE_TOL`` in
the Frobenius norm relative to the mesh-free leaf's, and each leaf of
params relative to the mesh-free leaf's update over the three steps (the
params themselves move too little for a wrong update to show beside
them: a wrong update reads about 1). The state's tolerance is AdamW's:
its first update is about lr·sign(g), so an element whose gradient is at
the level of rounding steps either way. GLM-4 and InternVL2's kv bias
``bk`` (whose gradient is zero up to rounding: softmax is blind to a
per-query shift) measured 2.3e-3 and 7.9e-3 of its update; the xLSTM smoke
grows rounding by orders of magnitude a step (its step losses 7.4e-4
apart, its params 2.0e-2 of their update, its mLSTM layer's moments 0.12
and 0.26), as the JAX package against the port does
(``tests/test_torch_train_hybrid.py``: 0.1 / 0.2).
"""
import functools
import types

import numpy as np

import _torch_zoo_train_tp_driver as drv
from _torch_train import jax_leaves, jax_loss_and_grads, jax_state, jax_steps
from repro_torch.models import zoo
from repro_torch.sharding import specs as sh

JAX_ARCHS = ("gemma-2b", "zamba2-1.2b")
TP_TOL = 1e-5
STEP_LOSS_TOL = {"xlstm-350m": 2e-3}
STATE_TOL = {"xlstm-350m": {"params": 5e-2, "mu": 0.5, "nu": 0.5},
             "glm4-9b": {"params": 2e-2}, "internvl2-1b": {"params": 2e-2}}
DEFAULT_STEP_LOSS_TOL, DEFAULT_STATE_TOL = 2e-4, 2e-3
# the JAX package against the port (tests/test_torch_train_*.py's)
JAX_GRAD_TOL = 2e-5
JAX_STEP_TOL = {"loss": 1e-3, "params": 2e-3, "mu": 2e-3, "nu": 2e-3}


def value(res: dict, key: str):
    return res[key].item() if res[key].ndim == 0 else res[key]


def runs_of(res: dict, name: str) -> list:
    """The runs (``plain``, a flag, ``flat``) a rank file holds for
    scenario ``name``."""
    return sorted({k.split("/")[1] for k in res
                   if k.startswith(name + "/") and k.endswith("/loss")
                   and k.split("/")[1] != "jax"})


def check_runs(ranks: list, name: str):
    """Every run of ``name`` on every rank against the mesh-free run."""
    runs = runs_of(ranks[0], name)
    assert runs, name
    for res in ranks:
        for run in runs:
            pre = f"{name}/{run}"
            assert value(res, pre + "/loss") <= TP_TOL, pre
            assert value(res, pre + "/grad") <= TP_TOL, pre
            assert value(res, pre + "/step_loss") <= STEP_LOSS_TOL.get(
                name, DEFAULT_STEP_LOSS_TOL), pre
            for key in ("params", "mu", "nu"):
                assert value(res, f"{pre}/state/{key}") <= STATE_TOL.get(
                    name, {}).get(key, DEFAULT_STATE_TOL), (pre, key)
            assert bool(value(res, pre + "/blocks")), pre


def check_replicated(ranks: list, name: str, model: int):
    """A gradient the specs replicate over "model" is the same on every
    rank of each model group (bit for bit)."""
    for run in runs_of(ranks[0], name):
        keys = [k for k in ranks[0] if k.startswith(f"{name}/{run}/rep/")]
        assert keys, (name, run)
        for g in range(len(ranks) // model):
            group = ranks[g * model:(g + 1) * model]
            for k in keys:
                assert all(np.array_equal(r[k], group[0][k])
                           for r in group), k


def stand_in(shape: dict, rank: int):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 rank=rank, model_shards=shape["model"])


def assemble(blocks: list, whole_shape, spec, shape: dict) -> np.ndarray:
    """The whole leaf from every rank's block (``blocks[r]``) by ``spec``
    on a mesh of ``shape``."""
    out = np.zeros(whole_shape, dtype=np.float64)
    for r, b in enumerate(blocks):
        coords = sh.mesh_coords(stand_in(shape, r))
        sl = []
        for d, entry in zip(sh.shard_shape(whole_shape, spec,
                                           stand_in(shape, r)), spec):
            i = 0
            for a in sh._entry_axes(entry):
                i = i * shape[a] + coords[a]
            sl.append(slice(i * d, (i + 1) * d))
        out[tuple(sl)] = b
    return out


@functools.lru_cache(maxsize=None)
def jax_npz(path: str) -> str:
    """The JAX ``init_train_state`` of JAX_ARCHS as ``<arch>/<leaf path>``
    arrays in the npz at ``path``."""
    import jax
    flat = {}
    for arch in JAX_ARCHS:
        st = jax_state(arch)
        for p, a in jax.tree_util.tree_leaves_with_path(st):
            flat[arch + "/" + "/".join(str(k.key) for k in p)] = np.asarray(a)
    np.savez(path, **flat)
    return path


def check_jax(ranks: list, arch: str, shape: dict):
    """The ranks' loss, metrics, gathered gradients and state after three
    steps against the JAX package's, at its training tests'
    tolerances."""
    cfg = drv.config(arch)
    mesh = stand_in(shape, 0)
    specs = zoo._state_specs(cfg, mesh, False, False, False)
    jl, jm, jg = jax_loss_and_grads(arch)
    js, jls = jax_steps(arch)
    for res in ranks:
        assert abs(value(res, f"{arch}/jax/loss") - jl) <= 1e-4
        for k, v in jm.items():
            assert abs(value(res, f"{arch}/jax/metric/{k}") - v) <= 1e-4, k
        for t, want in enumerate(jls):
            assert abs(value(res, f"{arch}/jax/step_loss/{t}") - want) <= \
                JAX_STEP_TOL["loss"]
        assert value(res, f"{arch}/jax/step") == 3
    worst = 0.0
    for i, (w, spec) in enumerate(zip(jg, zoo._spec_leaves(specs["params"]))):
        got = assemble([res[f"{arch}/jax/grad/{i}"] for res in ranks],
                       w.shape, spec, shape)
        worst = max(worst, float(np.abs(got - w).max()) / max(
            float(np.abs(w).max()), 1e-30) if w.size else 0.0)
    assert worst <= JAX_GRAD_TOL, worst
    for key in ("params", "mu", "nu"):
        for i, (w, spec) in enumerate(zip(jax_leaves(js[key]),
                                          zoo._spec_leaves(specs[key]))):
            got = assemble([res[f"{arch}/jax/{key}/{i}"] for res in ranks],
                           w.shape, spec, shape)
            err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= JAX_STEP_TOL[key], (key, i, err)
