"""One rank of the zoo's tensor-parallel training tests
(``tests/test_torch_zoo_train_tp*.py``).

    python tests/_torch_zoo_train_tp_driver.py RANK WORLD STORE OUT MODEL MODE [JAX]

joins a gloo world of WORLD ranks through the FileStore at STORE as a
``(WORLD / MODEL, MODEL)`` mesh and runs on the CPU with one torch thread.
MODE ``plain``: for each scenario of ``SCENARIOS`` (one smoke arch per
family, some with a variant), from one whole train state (torch init from
seed 0):

  - without a mesh: ``zoo.loss_and_grads`` on a batch of B rows, then
    ``STEPS`` ``zoo.train_step`` calls;
  - the rank's blocks (``zoo.shard_state``, its rows by ``data_specs``)
    through the same calls with ``mesh=``.

MODE ``flags``: ``FLAG_RUNS``, each flag's three steps against the plain
mesh run's (bit for bit) and against the run without a mesh; MODE
``flat``: ``--batch-over-model`` where no leaf is split over "model" (a
data mesh of every rank); MODE ``jax``: only the JAX npz's. A JAX npz
(``<arch>/<leaf path>`` of the JAX package's ``init_train_state``) runs
those archs from it instead, through ``train_state_from_numpy(mesh=)``,
on ``JAX_B`` rows, and keeps the rank's gradient and state blocks.

It writes OUT/rank<r>.npz: for each scenario and run
(``<name>/<run>/...``) the loss's difference from the mesh-free run's
(``loss``), each leaf's gradient block's largest difference over the whole
mesh-free leaf's largest magnitude (``grad``, ``tests/_torch_train.py``'s
``max_rel`` of the gathered gradient), the steps' losses' (``step_loss``)
and the final state's blocks' in the Frobenius norm of each leaf relative
to the mesh-free leaf's (``state/mu``, ``state/nu``; ``state/params``
relative to the mesh-free leaf's update over the steps: the largest over
the leaves), whether every state leaf is its
block's shape (``blocks``), the SHA-256 of each gradient the specs
replicate over "model" (``rep/<leaf>``), and for a flag run the largest
difference from the plain mesh run (``vs_plain``).

Imports no JAX: a rank is a process of the port.
"""
from __future__ import annotations

import hashlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

DRIVER = Path(__file__).resolve()
SRC = DRIVER.parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.modules import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

B, S, STEPS = 4, 16, 3          # B: the (data × model) ranks of (2, 2)
JAX_B = 2                       # tests/_torch_train.py's batch
# name -> (arch, config replacements)
SCENARIOS = {
    "gemma-2b": ("gemma-2b", {}),
    "glm4-9b": ("glm4-9b", {}),
    "internvl2-1b": ("internvl2-1b", {}),
    "hubert-xlarge": ("hubert-xlarge", {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m",
                             {"capacity_factor": 0.5}),
    "granite-moe-grouped": ("granite-moe-1b-a400m",
                            {"capacity_factor": 0.5, "moe_impl": "grouped"}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"mtp": True}),
    "zamba2-1.2b": ("zamba2-1.2b", {}),
    "xlstm-350m": ("xlstm-350m", {}),
}
# MODE flags: (scenario, flags)
FLAG_RUNS = (("gemma-2b", "zero"), ("gemma-2b", "fsdp"),
             ("gemma-2b", "batch_over_model"),
             ("zamba2-1.2b", "zero"), ("zamba2-1.2b", "fsdp"),
             ("zamba2-1.2b", "batch_over_model"),
             ("xlstm-350m", "fsdp"), ("xlstm-350m", "batch_over_model"),
             ("granite-moe-1b-a400m", "moe_2d"),
             ("granite-moe-grouped", "moe_2d"))
# the flags that must equal the plain mesh run bit for bit
BITWISE = ("zero", "fsdp", "batch_over_model")
# MODE flat: a batch over a model axis that splits no leaf (xLSTM on three
# ranks: 512 vocab rows do not divide), over every rank of the world
FLAT_B = 6


def config(name: str):
    arch, kw = SCENARIOS[name]
    return registry.smoke_variant(registry.get(arch)).replace(**kw)


def unflatten(z, prefix: str) -> dict:
    """The nested dict (lists where the keys are indices, as xLSTM's
    ``blocks_list``) of the ``prefix/...`` arrays of an npz."""
    out = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[k]

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(out)


def train_batch(cfg, rows: int, seed: int = 3) -> dict:
    """``tests/_torch_train.py``'s ``train_batches`` (the port's half) over
    ``rows`` rows: tokens and next-token labels with a few masked, the
    family's frames or patch embeddings."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1
    labels[1, -1] = -1
    b = {"tokens": tok[:, :-1], "labels": labels}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(rows, S, cfg.frontend_dim)).astype(
            np.float32)
    elif cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(rows, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                               else None) for k, v in b.items()}


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def rows(batch: dict, mesh, over_model: bool) -> dict:
    specs = sh.data_specs(batch, mesh, include_model=over_model)
    return sh.tree_blocks(batch, specs, mesh)


def rel(got: torch.Tensor, want: torch.Tensor, scale_of: torch.Tensor
        ) -> float:
    """max |got − want| over the whole leaf's max |·| (1e-30 at least)."""
    if not got.numel():
        return 0.0
    scale = max(float(scale_of.double().abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / scale


def fro(got: torch.Tensor, want: torch.Tensor, whole: torch.Tensor) -> float:
    """||got − want|| (blocks) over the whole leaf's norm."""
    return float(torch.linalg.vector_norm((got - want).double())) / max(
        float(torch.linalg.vector_norm(whole.double())), 1e-30)


def none_run(cfg, state, batch):
    """(loss, grads, step losses, final state) without a mesh."""
    loss, _, grads = zoo.loss_and_grads(state["params"], cfg, batch)
    st, losses = clone(state), []
    for _ in range(STEPS):
        st, m = zoo.train_step(st, batch, cfg)
        losses.append(float(m["loss"]))
    return float(loss), grads, losses, st


def mesh_run(cfg, local, batch, mesh, flags: dict):
    """The same calls on the rank's state blocks ``local``."""
    mine = rows(batch, mesh, flags.get("batch_over_model", False))
    loss, _, grads = zoo.loss_and_grads(
        local["params"], cfg, mine, mesh,
        fsdp=flags.get("fsdp", False), moe_2d=flags.get("moe_2d", False),
        batch_over_model=flags.get("batch_over_model", False))
    st, losses = clone(local), []
    for _ in range(STEPS):
        st, m = zoo.train_step(st, mine, cfg, mesh=mesh, **flags)
        losses.append(float(m["loss"]))
    return float(loss), grads, losses, st


def compare(res: dict, pre: str, cfg, ref, got, specs, mesh, init):
    """The errors of a mesh run ``got`` against the mesh-free ``ref`` into
    ``res`` under ``pre``; the rank's blocks of ``ref`` by ``specs``;
    ``init``: the whole params the runs started from."""
    r_loss, r_grads, r_losses, r_st = ref
    g_loss, g_grads, g_losses, g_st = got
    res[f"{pre}/loss"] = np.float64(abs(g_loss - r_loss))
    res[f"{pre}/step_loss"] = np.float64(max(
        abs(a - b) for a, b in zip(g_losses, r_losses)))
    p_specs = zoo._spec_leaves(specs["params"])
    worst = 0.0
    for g, w, sp in zip(g_grads, r_grads, p_specs):
        worst = max(worst, rel(g, sh.local_block(w, sp, mesh), w))
    res[f"{pre}/grad"] = np.float64(worst)
    ok = True
    for key in ("params", "mu", "nu"):
        worst = 0.0
        for g, w, sp, w0 in zip(
                tree_leaves(g_st[key]), tree_leaves(r_st[key]),
                zoo._spec_leaves(specs[key]), tree_leaves(init)):
            ok &= tuple(g.shape) == sh.shard_shape(tuple(w.shape), sp, mesh)
            # params: over the steps' whole update, which is small
            # beside the params themselves
            scale = w - w0 if key == "params" else w
            worst = max(worst, fro(g, sh.local_block(w, sp, mesh), scale))
        res[f"{pre}/state/{key}"] = np.float64(worst)
    res[f"{pre}/blocks"] = np.array(ok and int(g_st["step"]) == STEPS)
    for i, (g, sp) in enumerate(zip(g_grads, p_specs)):
        if not any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in sp):
            res[f"{pre}/rep/{i}"] = np.frombuffer(hashlib.sha256(
                g.contiguous().numpy().tobytes()).digest(), np.uint8)


def state_specs(cfg, mesh, flags: dict):
    return zoo._state_specs(cfg, mesh, flags.get("zero", False),
                            flags.get("fsdp", False),
                            flags.get("moe_2d", False))


def whole_state(cfg):
    return zoo.init_train_state(torch.Generator().manual_seed(0), cfg,
                                device="cpu")


def run_plain(mesh, res: dict):
    for name in SCENARIOS:
        cfg = config(name)
        state, batch = whole_state(cfg), train_batch(cfg, B)
        ref = none_run(cfg, state, batch)
        local = zoo.shard_state(clone(state), cfg, mesh)
        got = mesh_run(cfg, local, batch, mesh, {})
        compare(res, f"{name}/plain", cfg, ref, got,
                state_specs(cfg, mesh, {}), mesh, state["params"])


def run_flags(mesh, res: dict):
    plain = {}
    for name, flag in FLAG_RUNS:
        cfg = config(name)
        state, batch = whole_state(cfg), train_batch(cfg, B)
        if name not in plain:
            ref = none_run(cfg, state, batch)
            got = mesh_run(cfg, zoo.shard_state(clone(state), cfg, mesh),
                           batch, mesh, {})
            plain[name] = (ref, got)
        ref, base = plain[name]
        flags = {flag: True}
        local = zoo.shard_state(clone(state), cfg, mesh, **{
            k: v for k, v in flags.items() if k != "batch_over_model"})
        got = mesh_run(cfg, local, batch, mesh, flags)
        specs = state_specs(cfg, mesh, flags)
        pre = f"{name}/{flag}"
        compare(res, pre, cfg, ref, got, specs, mesh, state["params"])
        if flag not in BITWISE:
            continue
        # against the plain mesh run: its blocks cut to this layout's
        plain_specs = state_specs(cfg, mesh, {})
        diff = abs(got[0] - base[0]) + max(
            abs(a - b) for a, b in zip(got[2], base[2]))
        for g, w, sp in zip(got[1], base[1], zoo._spec_leaves(specs["params"])):
            diff = max(diff, float((g - cut(w, sp, mesh)).abs().max()))
        for key in ("params", "mu", "nu"):
            for g, w, sp, psp in zip(
                    tree_leaves(got[3][key]), tree_leaves(base[3][key]),
                    zoo._spec_leaves(specs[key]),
                    zoo._spec_leaves(plain_specs[key])):
                diff = max(diff, float((g - cut(w, sp, mesh, psp))
                                       .abs().max()))
        res[f"{pre}/vs_plain"] = np.float64(diff)


def run_flat(mesh, res: dict):
    name = "xlstm-350m"
    cfg = config(name)
    state, batch = whole_state(cfg), train_batch(cfg, FLAT_B)
    ref = none_run(cfg, state, batch)
    local = zoo.shard_state(clone(state), cfg, mesh)
    got = mesh_run(cfg, local, batch, mesh, {"batch_over_model": True})
    compare(res, f"{name}/flat", cfg, ref, got, state_specs(cfg, mesh, {}),
            mesh, state["params"])
    res[f"{name}/flat/rows"] = np.int64(
        rows(batch, mesh, True)["tokens"].shape[0])


def cut(t: torch.Tensor, spec, mesh, plain_spec=None) -> torch.Tensor:
    """A plain mesh run's block ``t`` cut further to ``spec``'s block where
    ``spec`` splits a dim over "data" that the plain layout does not."""
    for d, e in enumerate(spec):
        if e == "data" and (plain_spec is None or plain_spec[d] != "data"):
            n = t.shape[d] // mesh.fsdp_shards
            t = t.narrow(d, mesh.fsdp_index * n, n)
    return t


def run_jax(mesh, res: dict, z):
    """The archs of the JAX npz from its ``init_train_state``: the rank's
    loss, gradient blocks and state blocks after ``STEPS`` steps."""
    for name in SCENARIOS:
        arch = SCENARIOS[name][0]
        if name != arch or not any(k.startswith(arch + "/")
                                   for k in z.files):
            continue
        cfg = config(name)
        local = train_state_from_numpy(unflatten(z, arch), cfg=cfg,
                                       mesh=mesh)
        batch = train_batch(cfg, JAX_B)
        loss, metrics, grads = zoo.loss_and_grads(
            local["params"], cfg, rows(batch, mesh, False), mesh)
        res[f"{arch}/jax/loss"] = np.float64(loss)
        for k, v in metrics.items():
            res[f"{arch}/jax/metric/{k}"] = np.float64(v)
        for i, g in enumerate(grads):
            res[f"{arch}/jax/grad/{i}"] = g.numpy()
        st = local
        for t in range(STEPS):
            st, m = zoo.train_step(st, rows(batch, mesh, False), cfg,
                                   mesh=mesh)
            res[f"{arch}/jax/step_loss/{t}"] = np.float64(m["loss"])
        for key in ("params", "mu", "nu"):
            for i, a in enumerate(tree_leaves(st[key])):
                res[f"{arch}/jax/{key}/{i}"] = a.numpy()
        res[f"{arch}/jax/step"] = np.int64(st["step"])


def spawn_world(world: int, model: int, outdir: Path, mode: str,
                jax_npz=None, timeout: float = 300) -> list:
    """Run this script on ``world`` ranks as a (world / model, model) mesh
    -> each rank's npz (a failed rank fails the world)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = outdir / "store"
    extra = [str(jax_npz)] if jax_npz else []
    procs = [subprocess.Popen(
        [sys.executable, str(DRIVER), str(r), str(world), str(store),
         str(outdir), str(model), mode, *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, "\n".join(log[-3000:] for log in logs)
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


def main(argv) -> int:
    rank, world, store, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    model, mode = int(argv[4]), argv[5]
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world // model, model, device="cpu")
        res = {}
        if len(argv) > 6:
            run_jax(mesh, res, np.load(argv[6]))
        {"plain": run_plain, "flags": run_flags, "flat": run_flat,
         "jax": lambda m, r: None}[mode](mesh, res)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        mesh_lib.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
