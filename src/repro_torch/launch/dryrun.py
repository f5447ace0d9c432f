"""The dry run without a mesh (``repro.launch.dryrun`` less the mesh):
every (architecture × input shape) step built on ``meta`` tensors, run
once, and recorded as far as one device can tell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # 40 pairs

The reference lowers and compiles each step for a 512-device host mesh and
reads XLA's analyses. Here the step's inputs, params, train state and cache
are ``meta`` tensors (shapes and dtypes: nothing is allocated on any
device, as the reference's runs on placeholder host devices), and the step
runs once under ``torch.utils.flop_counter.FlopCounterMode``. A record
keeps the reference's keys where one device can give them:

  mesh             "1";
  trace_s          the meta run's seconds (for ``lower_s`` / ``compile_s``);
  memory_analysis  ``argument_size_in_bytes`` (the inputs with the params,
                   train state or cache), ``output_size_in_bytes`` and
                   ``alias_size_in_bytes`` (the donated train state or
                   cache), each the Σ ``nbytes`` of the meta tensors;
  cost_analysis    ``flops``, and ``flops_by_op``: the ops counted.

It differs from the reference in three ways, which every record also
names under ``differences``:
  - no ``temp_size_in_bytes``: a ``meta`` tensor has no allocator, so a
    step's temporaries are unknown here (``chip_smoke.py`` measures the
    peak of three steps on the card);
  - FLOPs count every layer, and only the ops FlopCounterMode knows
    (matmuls, convolutions, attention); the reference's
    ``cost_analysis`` counts a scan's body once (``repro/launch/
    dryrun.py:15-18``);
  - no collective inventory, and the flags whose only effect is a
    sharding raise ``NotImplementedError``: the zoo's tensor parallelism
    is ROADMAP.md queue 1, item 16d.

``serve_step`` returns a new cache rather than writing the donated one, so
on a card a decode step holds both; ``alias_size_in_bytes`` is the cache
the reference donates. Records go to ``experiments/dryrun_torch/``, one
JSON a run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry, shapes as shp
from repro_torch.launch.mesh import not_ported_16
from repro_torch.models import zoo

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

DIFFERENCES = {
    "temp_size_in_bytes": "not available: meta tensors have no allocator",
    "flops": "every layer counted, and only the ops FlopCounterMode knows; "
             "the reference counts scan bodies once",
    "collectives": "no mesh: ROADMAP.md queue 1, item 16d",
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


def refuse_sharding(**flags):
    """Raises ``NotImplementedError`` naming ROADMAP item 16d for the first
    sharding flag that is set."""
    for name, what in SHARDING_FLAGS.items():
        if flags.get(name):
            raise not_ported_16(f"--{name.replace('_', '-')} ({what})")


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
            smoke: bool = False, multi_pod: bool = False, zero: bool = False,
            fsdp: bool = False, cache_seq_shard: bool = False,
            mlstm_chunkwise: bool = False, xlstm_opt: bool = False,
            batch_over_model: bool = False, moe_2d: bool = False,
            bf16_params: bool = False, moe_grouped: bool = False,
            attn_chunk: int | None = None, save: bool = True,
            verbose: bool = True) -> dict:
    """The record of one (arch, shape) pair on ``meta``. ``shape`` replaces
    ``SHAPES[shape_name]`` (a batch cut, or a small shape for a smoke
    variant, ``smoke=True``)."""
    refuse_sharding(multi_pod=multi_pod, zero=zero, fsdp=fsdp,
                    cache_seq_shard=cache_seq_shard,
                    batch_over_model=batch_over_model, moe_2d=moe_2d)
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

    t0 = time.time()
    fn, args = build_step(cfg, shape)
    # the donated bytes are read before a train step mutates its state
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "status": "ok",
           "input_shape": dataclasses.asdict(shape), "smoke": smoke,
           "window": cfg.window,
           **measure(fn, args, alias=donated(shape, args), t0=t0)}
    mem_d = rec["memory_analysis"]
    if xlstm_opt:
        rec["sharding_left_out"] = SHARDING_FLAGS["batch_over_model"] + \
            " (--xlstm-opt): ROADMAP.md queue 1, item 16d"
    if verbose:
        print(f"OK {arch} x {shape_name} mesh=1 trace={rec['trace_s']:.1f}s")
        print(f"   memory: args={mem_d['argument_size_in_bytes'] / 2**30:.2f}"
              f"GiB out={mem_d['output_size_in_bytes'] / 2**30:.2f}GiB "
              f"alias={mem_d['alias_size_in_bytes'] / 2**30:.2f}GiB (no temp "
              "on meta)")
        print(f"   flops={rec['cost_analysis']['flops']:.3e}")
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        tag = f"{arch}_{shape_name}_1" + ("_smoke" if smoke else "") \
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
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--zero", action="store_true",
                    help="shard optimizer moments over the data axis (ZeRO-1)"
                         "; item 16")
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard params over the data axis (ZeRO-3); "
                         "item 16")
    ap.add_argument("--mlstm-chunkwise", action="store_true",
                    dest="mlstm_chunkwise",
                    help="chunkwise-parallel mLSTM instead of recurrent scan")
    ap.add_argument("--xlstm-opt", action="store_true", dest="xlstm_opt",
                    help="optimized xLSTM config: chunkwise Q=256 + unit "
                         "scan (its batch-over-model sharding is item 16)")
    ap.add_argument("--moe-2d", action="store_true", dest="moe_2d",
                    help="2-D expert parallelism; item 16")
    ap.add_argument("--attn-chunk", type=int, default=None, dest="attn_chunk",
                    help="query-chunked attention block size")
    ap.add_argument("--moe-grouped", action="store_true", dest="moe_grouped",
                    help="grouped (GShard-style) dispatch")
    ap.add_argument("--bf16-params", action="store_true", dest="bf16_params",
                    help="bf16 parameter storage (fp32 moments)")
    ap.add_argument("--batch-over-model", action="store_true",
                    dest="batch_over_model",
                    help="shard the train batch over the model axis; item 16")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    dest="cache_seq_shard",
                    help="shard decode caches over sequence; item 16")
    args = ap.parse_args(argv)
    refuse_sharding(**{k: getattr(args, k) for k in SHARDING_FLAGS})

    if args.all:
        pairs = [(a, s) for a in registry.ARCHS for s in shp.SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    results = []
    for a, s in pairs:
        try:
            results.append(run_one(a, s, mlstm_chunkwise=args.mlstm_chunkwise,
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
