"""One rank of the zoo's tensor-parallel tests
(``tests/test_torch_zoo_tp*.py``).

    python tests/_torch_zoo_tp_driver.py RANK WORLD STORE OUT MODEL [PARAMS]

joins a gloo world of WORLD ranks through the FileStore at STORE as a
``(WORLD / MODEL, MODEL)`` mesh and, for each scenario of ``SCENARIOS``
(one smoke arch per family, some with a variant), runs on the CPU with one
torch thread:

  - the whole model without a mesh: ``zoo.forward`` over a batch of B
    rows, then ``STEPS`` ``zoo.serve_step`` calls from an empty cache;
  - the rank's blocks (``zoo.shard_params``, the rows ``data_specs`` give
    it, ``zoo.init_cache(mesh=)``) through the same calls with ``mesh=``,
    and again with a slot-split cache (``cache_seq_shard``, ``kv_spec``)
    where the scenario says so.

It writes OUT/rank<r>.npz: for each scenario and run, the largest
difference from the mesh-free run of the rank's logits (prefill, every
decode step) and of each cache block against the same block of the
mesh-free cache, over the larger of 1 and the mesh-free values' largest
magnitude (``<name>/<run>/err/...``), whether every param and cache
leaf has exactly its block's shape (``<name>/<run>/blocks``) and how many
leaves are split, and the rank's gathered logits (``<name>/<run>/logits``,
``step<t>``) for the JAX comparisons. PARAMS, an ``.npz`` of
``<arch>/<leaf path>`` arrays (the JAX package's init), replaces the
torch init for the archs it holds.

Imports no JAX: a rank is a process of the port.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

DRIVER = Path(__file__).resolve()
SRC = DRIVER.parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

B, S, STEPS = 2, 16, 4
# name -> (arch, config replacements, slot-split decode too)
SCENARIOS = {
    "gemma-2b": ("gemma-2b", {}, True),
    "glm4-9b": ("glm4-9b", {}, False),
    "internvl2-1b": ("internvl2-1b", {}, False),
    "hubert-xlarge": ("hubert-xlarge", {}, False),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m",
                             {"capacity_factor": 0.5}, False),
    "granite-moe-grouped": ("granite-moe-1b-a400m",
                            {"capacity_factor": 0.5,
                             "moe_impl": "grouped"}, False),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"mtp": True}, True),
    "zamba2-1.2b": ("zamba2-1.2b", {}, False),
    "xlstm-350m": ("xlstm-350m", {}, False),
}


def config(name: str):
    arch, kw, _ = SCENARIOS[name]
    return registry.smoke_variant(registry.get(arch)).replace(**kw)


def unflatten(z, prefix: str) -> dict:
    """The nested dict of the ``prefix/...`` arrays of an npz."""
    out = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[k]
    return out


def has_jax(arch: str, jax_params) -> bool:
    return jax_params is not None and any(
        k.startswith(arch + "/") for k in jax_params.files)


def whole_params(name: str, cfg, jax_params):
    arch = SCENARIOS[name][0]
    if has_jax(arch, jax_params):
        return params_from_numpy(unflatten(jax_params, arch))
    return zoo.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


def batch(cfg, seed: int = 1) -> dict:
    """The family's inputs over B rows, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": torch.as_tensor(rng.normal(
            size=(B, S, cfg.frontend_dim)).astype(np.float32))}
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.long)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(B, 2, cfg.frontend_dim)).astype(np.float32))
    return out


def decode_tokens(cfg, seed: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, STEPS)),
                           dtype=torch.long)


def rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of a batch-leading tensor, by ``data_specs``."""
    spec = sh.data_specs({"x": t}, mesh)["x"]
    return sh.local_block(t, spec, mesh)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def blocks_check(whole, local, specs, mesh) -> tuple:
    """(every leaf of ``local`` is its block's shape, leaves split)."""
    ok, split = True, 0
    for (_, w), (_, l), (_, s) in zip(leaves(whole), leaves(local),
                                      sh.spec_items(specs)):
        want = sh.shard_shape(tuple(w.shape), s, mesh)
        ok &= tuple(l.shape) == want
        split += want != tuple(w.shape)
    return ok, split


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max(1, max |b|)."""
    if not a.numel():
        return 0.
    return float((a.double() - b.double()).abs().max()
                 / max(1.0, float(b.double().abs().max())))


def none_run(cfg, params, inputs, toks):
    """The mesh-free run: prefill logits (with the MTP head's), each
    decode step's logits, the final cache."""
    with torch.no_grad():
        logits, aux = zoo.forward(params, cfg, inputs, return_hidden=cfg.mtp)
        out = {"logits": logits}
        if cfg.mtp:
            out["mtp"] = zoo.mtp_logits(params, cfg, aux["hidden"],
                                        inputs["tokens"])
        if not cfg.decode_supported:
            return out, None
        cache = zoo.init_cache(cfg, B, STEPS, device="cpu")
        for t in range(STEPS):
            out[f"step{t}"], cache = zoo.serve_step(
                params, cfg, cache, toks[:, t:t + 1], torch.full((B,), t))
    return out, cache


def mesh_run(cfg, params, inputs, toks, mesh, seq: bool, local=None):
    """The same calls on the rank's blocks (``local``, else cut from
    ``params``): (outputs, cache, cache specs, params' blocks)."""
    if local is None:
        local = zoo.shard_params(params, cfg, mesh)
    mine = {k: rows(v, mesh) for k, v in inputs.items()}
    with torch.no_grad():
        logits, aux = zoo.forward(local, cfg, mine, return_hidden=cfg.mtp,
                                  mesh=mesh)
        out = {"logits": logits}
        if cfg.mtp:
            out["mtp"] = zoo.mtp_logits(local, cfg, aux["hidden"],
                                        mine["tokens"], mesh=mesh)
        if not cfg.decode_supported:
            return out, None, None, local
        whole = zoo.init_cache(cfg, B, STEPS, device="meta")
        cspecs = sh.cache_specs(whole, cfg, mesh, mp=mesh.model_shards,
                                seq_shard=seq)
        kv_spec = None
        if seq:
            leaf = cspecs.get("k", cspecs.get("c_kv"))
            kv_spec = tuple(leaf[1:])
        cache = zoo.init_cache(cfg, B, STEPS, device="cpu", mesh=mesh,
                               seq_shard=seq)
        tk = rows(toks, mesh)
        for t in range(STEPS):
            out[f"step{t}"], cache = zoo.serve_step(
                local, cfg, cache, tk[:, t:t + 1],
                torch.full((tk.shape[0],), t), kv_spec=kv_spec, mesh=mesh)
    return out, cache, cspecs, local


def run_scenario(name: str, mesh, jax_params) -> dict:
    cfg = config(name)
    params = whole_params(name, cfg, jax_params)
    inputs, toks = batch(cfg), decode_tokens(cfg)
    ref, ref_cache = none_run(cfg, params, inputs, toks)
    res = {}
    runs = ["plain"] + (["seq"] if SCENARIOS[name][2] else [])
    arch = SCENARIOS[name][0]
    # the JAX init goes to the rank's blocks straight from numpy
    local = params_from_numpy(unflatten(jax_params, arch), cfg=cfg,
                              mesh=mesh) if has_jax(arch, jax_params) \
        else None
    for run in runs:
        out, cache, cspecs, local = mesh_run(cfg, params, inputs, toks, mesh,
                                             run == "seq", local)
        pre = f"{name}/{run}"
        pok, psplit = blocks_check(params, local, sh.param_specs(
            params, cfg, mp=mesh.model_shards), mesh)
        for k, v in out.items():
            res[f"{pre}/err/{k}"] = np.float64(rel_err(v, rows(ref[k],
                                                                mesh)))
            res[f"{pre}/out/{k}"] = v.float().numpy()
        if cache is not None:
            cok, csplit = blocks_check(ref_cache, cache, cspecs, mesh)
            pok &= cok
            psplit += csplit
            for (path, got), (_, want), (_, s) in zip(
                    leaves(cache), leaves(ref_cache),
                    sh.spec_items(cspecs)):
                res[f"{pre}/err/cache{path}"] = np.float64(rel_err(
                    got, sh.local_block(want, s, mesh)))
        res[f"{pre}/blocks"] = np.array(pok)
        res[f"{pre}/split"] = np.int64(psplit)
    return res


def spawn_world(world: int, model: int, outdir: Path, params_npz=None,
                timeout: float = 300) -> list:
    """Run the driver on ``world`` ranks as a (world / model, model) mesh
    -> each rank's npz (a failed rank fails the world)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = outdir / "store"
    extra = [str(params_npz)] if params_npz else []
    procs = [subprocess.Popen(
        [sys.executable, str(DRIVER), str(r), str(world), str(store),
         str(outdir), str(model), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    model = int(argv[4])
    jax_params = np.load(argv[5]) if len(argv) > 5 else None
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world // model, model, device="cpu")
        res = {}
        for name in SCENARIOS:
            res.update(run_scenario(name, mesh, jax_params))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        mesh_lib.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
