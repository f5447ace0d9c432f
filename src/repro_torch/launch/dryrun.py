"""The zoo's dry run (``repro.launch.dryrun``): every (architecture ×
input shape) step built on ``meta`` tensors, run once, and recorded.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all               # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod   # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1      # no mesh

The reference lowers and compiles each step for a 512-device host mesh and
reads XLA's analyses. Here the step's inputs, params, train state and cache
are ``meta`` tensors (shapes and dtypes: nothing is allocated on any
device, as the reference's runs on placeholder host devices), and the step
runs once under ``torch.utils.flop_counter.FlopCounterMode``.

By default the CLI makes a ``fake`` process group of 256 ranks (512 with
``--multi-pod``) in its own process, as ``launch/fed_dryrun.py`` does, and
runs rank 0's program of a pair on the production mesh
(``launch.mesh.make_production_mesh``: 16 × 16 as ("data", "model"), or 2 ×
16 × 16 with a leading "pod"): its blocks of the params
(``sharding.specs.param_specs``, with ``--fsdp`` also over "data"), its
rows of the batch (``data_specs``) and its blocks of the cache
(``cache_specs``, with ``--cache-seq-shard`` the slot-split layout),
through ``zoo.forward`` / ``zoo.serve_step`` with ``mesh=``; a train pair
through ``zoo.train_step(mesh=)`` on its blocks of the train state
(``state_specs(zero=, fsdp=, moe_2d=)``) and of the batch
(``data_specs(include_model=--batch-over-model)``; ``--xlstm-opt`` turns
it on, as the reference does), the forward, the backward (with each remat
recompute) and the gradient's reduction. ``--mesh 1`` runs the step of one
device, as before; the flags that shard over a mesh are a ``ValueError``
there. A record keeps the reference's keys where the port can give
them:

  mesh             "16x16", "2x16x16" (and ``axes``), or "1";
  zero, fsdp, batch_over_model, moe_2d
                   the layout flags (the reference's ``zero`` / ``fsdp``);
  trace_s          the meta run's seconds (for ``lower_s`` / ``compile_s``);
  memory_analysis  ``argument_size_in_bytes`` (the inputs with the params,
                   train state or cache: rank 0's blocks on a mesh),
                   ``output_size_in_bytes`` and ``alias_size_in_bytes``
                   (the donated train state or cache), each the Σ
                   ``nbytes`` of the meta tensors;
  cost_analysis    ``flops``, and ``flops_by_op``: the ops counted;
  collectives      on a mesh: ``n_collectives``,
                   ``collective_bytes_total`` / ``_by_kind`` (each
                   collective's buffer on rank 0), ``collectives_by_op``
                   and ``collectives_by_group`` (world, data, model),
                   counted by ``CommDebugMode`` and logged by the mesh
                   (``FedMesh.comm_log``), which must agree.

How it differs from the reference, each record names under
``differences`` (``DIFFERENCES``, ``MESH_DIFFERENCES``).

``serve_step`` returns a new cache rather than writing the donated one, so
on a card a decode step holds both; ``alias_size_in_bytes`` is the cache
the reference donates. Records go to ``experiments/dryrun_torch/``, one
JSON a run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry, shapes as shp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.sharding import specs as sh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

DIFFERENCES = {
    "temp_size_in_bytes": "not available: meta tensors have no allocator",
    "flops": "every layer counted, and only the ops FlopCounterMode knows; "
             "the reference counts scan bodies once",
    "collectives": "no mesh (--mesh 1): the production mesh's records "
                   "carry them",
}
# what a production-mesh record differs in from the reference's HLO parse
MESH_DIFFERENCES = {
    **DIFFERENCES,
    "collectives": "the port's own collectives (FedMesh sums and gathers "
                   "over the model and data groups, as the zoo's layers "
                   "call them), counted by CommDebugMode and the mesh's "
                   "log, not the ones XLA's partitioner inserts and the "
                   "reference parses from partitioned HLO; bytes are each "
                   "collective's buffer on rank 0 (a gather's whole "
                   "output), every layer counted (no loop multipliers)",
    "collective_dtype": "row-parallel partial sums and gathers move as fp32 "
                        "(bf16 activations are summed in fp32, then cast "
                        "back)",
    "flops": "rank 0's program, every layer counted, only the ops "
             "FlopCounterMode knows",
    "argument_size_in_bytes": "rank 0's blocks: params by param_specs, "
                              "batch by data_specs, cache by cache_specs",
    "kv_spec": "with --cache-seq-shard an MLA cache takes the slot-split "
               "decode too (the reference passes kv_spec for an attention "
               "cache only and leaves MLA's to XLA)",
    "train": "the backward's collectives are the port's own (each forward "
             "sum's, gather's and entry's autograd Function: an entry's "
             "backward is a model-group sum, a ZeRO-3 gather's a data-group "
             "sum then a cut), a remat recompute's forward collectives up "
             "to the layer's last tensor the backward needs are counted "
             "again, and the gradient is summed over the data "
             "group one all_reduce a leaf (fp32 on the wire; gloo takes "
             "only all_reduce and broadcast for CUDA tensors, so gathers, "
             "reduce-scatters and the --moe-2d all-to-all are zero-filled "
             "sums there); alias_size_in_bytes is the state's blocks, "
             "updated in place",
}

# flags whose only effect is a sharding: (argparse dest, what it shards)
SHARDING_FLAGS = {
    "multi_pod": "the 2x16x16 multi-pod mesh",
    "zero": "optimizer moments sharded over the data axis (ZeRO-1)",
    "fsdp": "params sharded over the data axis (ZeRO-3)",
    "cache_seq_shard": "decode caches sharded over the sequence",
    "batch_over_model": "the train batch sharded over the model axis",
    "moe_2d": "experts sharded over data x model",
}
# every one runs on the production mesh (--fsdp shards the params of
# prefill and decode too); --mesh 1 has no mesh for them


def check_flags(mesh: str, **flags):
    """Raises ``ValueError`` for a flag that shards over a mesh given with
    ``mesh="1"`` (no mesh)."""
    if mesh == "1":
        on = [f"--{k.replace('_', '-')}" for k in SHARDING_FLAGS
              if flags.get(k)]
        if on:
            raise ValueError(f"{', '.join(on)} run on the production mesh, "
                             "not --mesh 1")


def arch_config(arch: str, *, smoke: bool = False, bf16_params: bool = False,
                moe_grouped: bool = False, attn_chunk: int | None = None,
                mlstm_chunkwise: bool = False,
                xlstm_opt: bool = False) -> zoo.ArchConfig:
    """The registry's config (its smoke variant with ``smoke``), with the
    dry run's config flags applied as the reference applies them."""
    base = registry.get(arch)
    if smoke:
        base = registry.smoke_variant(base)
    if bf16_params:
        base = base.replace(param_dtype="bfloat16")
    if moe_grouped:
        base = base.replace(moe_impl="grouped")
    if attn_chunk:
        base = base.replace(attn_q_chunk=attn_chunk)
    if mlstm_chunkwise:
        base = base.replace(mlstm_impl="chunkwise")
    if xlstm_opt:
        base = base.replace(mlstm_impl="chunkwise", xlstm_chunk=256,
                            xlstm_scan_units=True)
    return base


def input_specs(cfg: zoo.ArchConfig, shape: shp.InputShape) -> dict:
    """``meta`` stand-ins for every model input of this workload."""
    if shape.kind in ("train", "prefill"):
        return shp.batch_specs(cfg, shape)
    return shp.decode_specs(cfg, shape)


def example_inputs(cfg: zoo.ArchConfig, shape: shp.InputShape, device,
                   gen: torch.Generator) -> dict:
    """``input_specs``' tensors made real on ``device``: tokens and labels
    uniform over the vocabulary, float inputs standard normal, ``pos`` the
    cache's last slot and an empty cache (``zoo.init_cache``)."""
    specs = input_specs(cfg, shape)
    out = {}
    for k, t in specs.items():
        if k == "cache":
            out[k] = zoo.init_cache(cfg, shape.global_batch,
                                    shp.cache_len(cfg, shape), device=device)
        elif k == "pos":
            out[k] = torch.full(t.shape, shp.cache_len(cfg, shape) - 1,
                                dtype=t.dtype, device=device)
        elif t.is_floating_point():
            out[k] = torch.randn(t.shape, generator=gen, device=device,
                                 dtype=torch.float32).to(t.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   device=device, dtype=t.dtype)
    return out


def build_step(cfg: zoo.ArchConfig, shape: shp.InputShape, device="meta",
               gen: torch.Generator | None = None):
    """Returns (fn, args) of the workload's step: ``zoo.train_step`` on a
    train state, ``zoo.forward``'s logits, or ``zoo.serve_step``. On
    ``meta`` everything is shapes only (``gen`` unused); on another device
    the params are drawn from ``gen`` (a generator on that device) and the
    inputs are ``example_inputs``."""
    meta = torch.device(device).type == "meta"
    ins = input_specs(cfg, shape) if meta else example_inputs(cfg, shape,
                                                              device, gen)
    if shape.kind == "train":
        state = zoo.init_train_state(gen, cfg, device=device)

        def train(state, batch):
            return zoo.train_step(state, batch, cfg)
        return train, (state, ins)
    params = zoo.init_params(gen, cfg, device=device)
    if shape.kind == "prefill":
        def prefill(params, batch):
            logits, _ = zoo.forward(params, cfg, batch)
            return logits
        return prefill, (params, ins)

    def decode(params, cache, tokens, pos):
        return zoo.serve_step(params, cfg, cache, tokens, pos)
    return decode, (params, ins["cache"], ins["tokens"], ins["pos"])


def mesh_step(cfg: zoo.ArchConfig, shape: shp.InputShape, mesh,
              cache_seq_shard: bool = False, *, zero: bool = False,
              fsdp: bool = False, batch_over_model: bool = False,
              moe_2d: bool = False):
    """(fn, args) of a rank's step on ``mesh``, on ``meta``: its blocks of
    the params (``param_specs`` at the mesh's model axis; with ``fsdp``
    also over "data"), of the batch or tokens and positions
    (``data_specs``) and of the cache (``cache_specs(seq_shard=
    cache_seq_shard)``; ``kv_spec``, one layer's spec of the attention or
    MLA cache, when it is slot-split); a train pair's blocks of the train
    state (``state_specs(zero=, fsdp=, moe_2d=)``) and of the batch
    (``data_specs(include_model=batch_over_model)``) through
    ``zoo.train_step(mesh=)``."""
    M, gb = mesh.model_shards, shape.global_batch
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        whole = zoo.init_train_state(None, cfg, device="meta")
        state = zoo.shard_state(whole, cfg, mesh, zero=zero, fsdp=fsdp,
                                moe_2d=moe_2d)
        batch = sh.tree_blocks(ins, sh.data_specs(
            ins, mesh, include_model=batch_over_model), mesh)

        def train(state, batch):
            return zoo.train_step(state, batch, cfg, mesh=mesh,
                                  global_batch=gb, zero=zero, fsdp=fsdp,
                                  moe_2d=moe_2d,
                                  batch_over_model=batch_over_model)
        return train, (state, batch)
    whole = zoo.init_params(None, cfg, device="meta")
    params = zoo.shard_params(whole, cfg, mesh, fsdp=fsdp)
    if shape.kind == "prefill":
        batch = sh.tree_blocks(ins, sh.data_specs(ins, mesh), mesh)

        def prefill(params, batch):
            logits, _ = zoo.forward(params, cfg, batch, mesh=mesh,
                                    global_batch=gb, fsdp=fsdp)
            return logits
        return prefill, (params, batch)
    c_specs = sh.cache_specs(ins["cache"], cfg, mesh, mp=M,
                             seq_shard=cache_seq_shard)
    cache = sh.tree_blocks(ins["cache"], c_specs, mesh)
    tp = {k: ins[k] for k in ("tokens", "pos")}
    tp = sh.tree_blocks(tp, sh.data_specs(tp, mesh), mesh)
    kv_spec = None
    key = "k" if "k" in c_specs else ("c_kv" if "c_kv" in c_specs else None)
    if cache_seq_shard and key is not None and \
            zoo._slot_split(c_specs[key][1:]):
        kv_spec = tuple(c_specs[key][1:])

    def decode(params, cache, tokens, pos):
        return zoo.serve_step(params, cfg, cache, tokens, pos,
                              kv_spec=kv_spec, mesh=mesh, global_batch=gb,
                              fsdp=fsdp)
    return decode, (params, cache, tp["tokens"], tp["pos"])


@contextlib.contextmanager
def fake_world(multi_pod: bool = False):
    """A ``fake`` process group of 256 ranks (512 with ``multi_pod``) made
    here, this process rank 0, and its production mesh on ``meta``; the
    group is destroyed on the way out. The caller must hold no process
    group (the CLIs run in a process of their own)."""
    if dist.is_initialized():
        raise RuntimeError("a production-mesh record makes its own fake "
                           "process group; run it in a process that holds "
                           "none")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                            device="meta")
    finally:
        mesh_lib.destroy_process_group()


def measure_on_mesh(mesh, fn, args, *, alias: int = 0,
                    differences=MESH_DIFFERENCES,
                    t0: float | None = None) -> dict:
    """``measure`` of rank 0's ``fn(*args)`` on ``mesh`` (a ``fake_world``
    one), with its collective inventory: ``CommDebugMode``'s count must
    equal the mesh's log (``FedMesh.comm_log``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    mesh.comm_log = []
    try:
        with CommDebugMode() as comm:
            measured = measure(fn, args, alias=alias,
                               differences=differences, t0=t0)
        log = mesh.comm_log
    finally:
        mesh.comm_log = None
    if comm.get_total_counts() != len(log):
        raise RuntimeError(f"CommDebugMode counted {comm.get_total_counts()} "
                           f"collectives, the mesh logged {len(log)}")
    by_kind, by_group = {}, {}
    for kind, group, nb in log:
        by_kind[kind] = by_kind.get(kind, 0) + nb
        g = by_group.setdefault(group, {"n": 0, "bytes": 0})
        g["n"] += 1
        g["bytes"] += nb
    return {"mesh": "x".join(str(v) for v in mesh.shape.values()),
            "axes": list(mesh.axis_names), **measured,
            "collective_bytes_total": int(sum(by_kind.values())),
            "collective_bytes_by_kind": by_kind,
            "n_collectives": len(log),
            "collectives_by_op": {str(k): int(v) for k, v in
                                  comm.get_comm_counts().items()},
            "collectives_by_group": by_group}


def nbytes(tree) -> int:
    """Σ ``nbytes`` of the tensors of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return 0


def count_flops(fn, args) -> tuple:
    """(output, total FLOPs, {op: FLOPs}) of one ``fn(*args)`` under
    ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    by_op = {str(op): int(n) for op, n in
             fc.get_flop_counts().get("Global", {}).items()}
    return out, int(fc.get_total_flops()), by_op


def donated(shape: shp.InputShape, args) -> int:
    """Bytes the reference donates: the train state, or the cache."""
    if shape.kind == "train":
        return nbytes(args[0])
    if shape.kind == "decode":
        return nbytes(args[1])
    return 0


def measure(fn, args, *, alias: int = 0, differences=DIFFERENCES,
            t0: float | None = None) -> dict:
    """A record's measured part for one ``fn(*args)`` on ``meta``:
    ``trace_s`` (from ``t0``, now by default), ``memory_analysis`` with
    ``alias`` the donated bytes, ``cost_analysis`` and the
    ``differences`` from the reference."""
    t0 = time.time() if t0 is None else t0
    arg_bytes = nbytes(args)
    out, flops, by_op = count_flops(fn, args)
    return {"trace_s": round(time.time() - t0, 2),
            "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                                "output_size_in_bytes": nbytes(out),
                                "alias_size_in_bytes": alias},
            "cost_analysis": {"flops": float(flops), "flops_by_op": by_op},
            "differences": differences}


def run_one(arch: str, shape_name: str, *, shape: shp.InputShape | None = None,
            smoke: bool = False, mesh: str = "production",
            multi_pod: bool = False, zero: bool = False, fsdp: bool = False,
            cache_seq_shard: bool = False, mlstm_chunkwise: bool = False,
            xlstm_opt: bool = False, batch_over_model: bool = False,
            moe_2d: bool = False, bf16_params: bool = False,
            moe_grouped: bool = False, attn_chunk: int | None = None,
            save: bool = True, verbose: bool = True) -> dict:
    """The record of one (arch, shape) pair on ``meta``: rank 0's on the
    production mesh in a ``fake_world`` made here (the caller must hold no
    process group), or with ``mesh="1"`` the step of one device. ``shape``
    replaces ``SHAPES[shape_name]`` (a batch cut, or a small shape for a
    smoke variant, ``smoke=True``). ``xlstm_opt`` turns on
    ``batch_over_model``, as the reference does."""
    on_mesh = mesh != "1"
    if xlstm_opt and on_mesh:
        batch_over_model = True
    check_flags(mesh, multi_pod=multi_pod, cache_seq_shard=cache_seq_shard,
                zero=zero, fsdp=fsdp, batch_over_model=batch_over_model,
                moe_2d=moe_2d)
    base = arch_config(arch, smoke=smoke, bf16_params=bf16_params,
                       moe_grouped=moe_grouped, attn_chunk=attn_chunk,
                       mlstm_chunkwise=mlstm_chunkwise, xlstm_opt=xlstm_opt)
    shape = shape or shp.SHAPES[shape_name]
    ok, why = shp.supported(base, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {why}")
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": why}
    cfg = shp.config_for(base, shape)

    head = {"arch": arch, "shape": shape_name, "status": "ok",
            "input_shape": dataclasses.asdict(shape), "smoke": smoke,
            "window": cfg.window}
    t0 = time.time()
    if on_mesh:
        flags = dict(zero=zero, fsdp=fsdp, batch_over_model=batch_over_model,
                     moe_2d=moe_2d)
        with fake_world(multi_pod) as m:
            fn, args = mesh_step(cfg, shape, m, cache_seq_shard, **flags)
            rec = {**head, "multi_pod": multi_pod,
                   "cache_seq_shard": cache_seq_shard, **flags,
                   **measure_on_mesh(m, fn, args, alias=donated(shape, args),
                                     t0=t0)}
    else:
        fn, args = build_step(cfg, shape)
        # the donated bytes are read before a train step mutates its state
        rec = {**head, "mesh": "1",
               **measure(fn, args, alias=donated(shape, args), t0=t0)}
    mem_d = rec["memory_analysis"]
    if verbose:
        print(f"OK {arch} x {shape_name} mesh={rec['mesh']} "
              f"trace={rec['trace_s']:.1f}s")
        print(f"   memory: args={mem_d['argument_size_in_bytes'] / 2**30:.2f}"
              f"GiB out={mem_d['output_size_in_bytes'] / 2**30:.2f}GiB "
              f"alias={mem_d['alias_size_in_bytes'] / 2**30:.2f}GiB (no temp "
              "on meta)")
        print(f"   flops={rec['cost_analysis']['flops']:.3e}"
              + (f" collectives={rec['n_collectives']} "
                 f"({rec['collective_bytes_total']:.3e} B)" if on_mesh
                 else ""))
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        tag = f"{arch}_{shape_name}_{rec['mesh']}" \
            + ("_zero" if zero else "") + ("_fsdp" if fsdp else "") \
            + ("_bom" if batch_over_model else "") \
            + ("_moe2d" if moe_2d else "") \
            + ("_seqshard" if cache_seq_shard else "") \
            + ("_smoke" if smoke else "") \
            + ("_chunkwise" if mlstm_chunkwise else "") \
            + ("_xlstmopt" if xlstm_opt else "") \
            + ("_bf16p" if bf16_params else "") \
            + ("_grouped" if moe_grouped else "") \
            + (f"_qc{attn_chunk}" if attn_chunk else "")
        with open(os.path.join(OUT_DIR, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("production", "1"),
                    default="production",
                    help="the production mesh (16x16, or 2x16x16 with "
                         "--multi-pod) in a fake world, or 1: no mesh")
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--zero", action="store_true",
                    help="shard optimizer moments over the data axis "
                         "(ZeRO-1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard params over the data axis (ZeRO-3; "
                         "prefill and decode too)")
    ap.add_argument("--mlstm-chunkwise", action="store_true",
                    dest="mlstm_chunkwise",
                    help="chunkwise-parallel mLSTM instead of recurrent scan")
    ap.add_argument("--xlstm-opt", action="store_true", dest="xlstm_opt",
                    help="optimized xLSTM config: chunkwise Q=256 + unit "
                         "scan, and the train batch over the model axis")
    ap.add_argument("--moe-2d", action="store_true", dest="moe_2d",
                    help="2-D expert parallelism (train pairs)")
    ap.add_argument("--attn-chunk", type=int, default=None, dest="attn_chunk",
                    help="query-chunked attention block size")
    ap.add_argument("--moe-grouped", action="store_true", dest="moe_grouped",
                    help="grouped (GShard-style) dispatch")
    ap.add_argument("--bf16-params", action="store_true", dest="bf16_params",
                    help="bf16 parameter storage (fp32 moments)")
    ap.add_argument("--batch-over-model", action="store_true",
                    dest="batch_over_model",
                    help="shard the train batch over the model axis")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    dest="cache_seq_shard",
                    help="shard decode caches over the slots where the kv "
                         "heads do not divide the model axis")
    args = ap.parse_args(argv)
    try:
        check_flags(args.mesh, **{k: getattr(args, k) for k in SHARDING_FLAGS})
    except ValueError as e:
        ap.error(str(e))

    if args.all:
        pairs = [(a, s) for a in registry.ARCHS for s in shp.SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    results = []
    for a, s in pairs:
        try:
            results.append(run_one(a, s, mesh=args.mesh,
                                   multi_pod=args.multi_pod,
                                   cache_seq_shard=args.cache_seq_shard,
                                   zero=args.zero, fsdp=args.fsdp,
                                   batch_over_model=args.batch_over_model,
                                   moe_2d=args.moe_2d,
                                   mlstm_chunkwise=args.mlstm_chunkwise,
                                   xlstm_opt=args.xlstm_opt,
                                   bf16_params=args.bf16_params,
                                   moe_grouped=args.moe_grouped,
                                   attn_chunk=args.attn_chunk))
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            print(f"FAIL {a} x {s}: {type(e).__name__}: {e}")
            results.append({"arch": a, "shape": s, "status": "fail",
                            "error": f"{type(e).__name__}: {e}"})
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skip, {n_fail} fail ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
