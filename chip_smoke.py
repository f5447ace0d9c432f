#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises and exits non-zero,
with no final ``ok`` line):

  1. device   — fail without CUDA; print the card's name and power limit
                (nvidia-smi) and build the kernels from ``src/repro_torch/
                csrc`` (nvcc, one process per source).
  2. kernels  — each hand-written kernel against its plain PyTorch version
                on the same inputs at the main path's shapes and ragged ones:
                max abs error (tolerance 3e-5, fp32 sums in another order),
                kernel / plain / library-call time (CUDA events, warmed,
                many launches), the least time the card could take.
  3. reference — a tiny run on the CPU (plain versions) and on the card
                (kernels) with the same draws must agree; it is also the
                warm-up of the card's libraries.
  4. main     — FedGroup on the paper's FEMNIST MLP-512 (d_w = 415,258):
                Alg. 3 cold start + 3 fused rounds with measure=edc, then
                with measure=madc; per-round metrics, cold-start and round
                time (host clock around work ending in synchronize()), peak
                device memory, and the kernels' launch counts (reset just
                before each run, read just after).
  5. breakdown — where the time goes: the batched local solver (the
                cold start's 100 clients, a round's 20) vs the EDC / MADC
                measure on the same inputs; one more round under
                torch.profiler for the device's busy share.
  6. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TOL = 3e-5                     # kernel vs plain: fp32 sums in another order
ROUNDS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(torch):
    """Phase 2: every kernel against its plain version, on the card."""
    import torch.nn.functional as F

    from repro_torch.core.measures import cosine_similarity_matrix
    from repro_torch.kernels import edc_cosine as edc_mod
    from repro_torch.kernels import madc as madc_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def edc_case(n, d, m, dtype, label):
        dW = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        V = torch.randn((d, m), generator=gen, device="cuda").to(dtype)
        got = edc_mod.edc_cosine(dW, V)
        want = ref.cosine_block_ref(dW, V)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        es = dW.element_size()
        b_ms, b_by = bound_ms(n * d * es + d * m * V.element_size()
                              + n * m * 4, 2.0 * n * d * (m + 1))
        row = {"phase": "kernel", "name": "edc_cosine", "case": label,
               "n": n, "d": d, "m": m, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "tol": TOL,
               "ms": cuda_ms(torch, lambda: edc_mod.edc_cosine(dW, V), 20),
               "plain_ms": cuda_ms(torch,
                                   lambda: ref.cosine_block_ref(dW, V), 10),
               "library_ms": cuda_ms(torch, lambda: F.cosine_similarity(
                   dW[:, :, None].float(), V[None].float(), dim=1), 3,
                   warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not err <= TOL:
            raise AssertionError(f"edc_cosine {label}: max abs err {err}")
        return row

    def madc_case(n, label):
        x = torch.randn((n, 64), generator=gen, device="cuda")
        M = cosine_similarity_matrix(x).contiguous()
        got = madc_mod.madc(M)
        want = ref.madc_ref(M)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # MADC(i, j) = MADC(j, i): the function needs the n(n-1)/2 distinct
        # pairs, each a select, a subtract, an abs-add over n-2 z's; M read
        # once, the (n, n) result written once
        b_ms, b_by = bound_ms(2.0 * n * n * 4,
                              3.0 * n * (n - 1) * max(n - 2, 0) / 2)
        row = {"phase": "kernel", "name": "madc", "case": label, "n": n,
               "dtype": "float32", "max_abs_err": err, "tol": TOL,
               "ms": cuda_ms(torch, lambda: madc_mod.madc(M), 20),
               "plain_ms": cuda_ms(torch, lambda: ref.madc_ref(M), 5),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not err <= TOL:
            raise AssertionError(f"madc {label}: max abs err {err}")
        return row

    rows["edc_cosine"] = edc_case(100, 415_258, 5, torch.float32, "main")
    edc_case(37, 100_003, 3, torch.bfloat16, "ragged-bf16")
    edc_case(130, 4_097, 16, torch.float32, "ragged-m16")
    edc_case(9, 333, 11, torch.bfloat16, "ragged-small-bf16")
    rows["madc"] = madc_case(100, "main")
    madc_case(257, "ragged")
    madc_case(1024, "large")
    madc_case(3, "tiny")
    return rows


def fedgroup_run(torch, data, model, measure: str):
    """Phase 4: one FedGroup run at full width; returns its record."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.engine import FedConfig
    from repro_torch.kernels import ops

    cfg = FedConfig(n_rounds=ROUNDS, clients_per_round=20, local_epochs=2,
                    batch_size=10, lr=0.03, n_groups=5, pretrain_scale=20,
                    measure=measure, seed=0)
    tr = FedGroupTrainer(model, data, cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pre_idx, labels = tr.group_cold_start()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    sizes = [int(v) for v in
             torch.bincount(torch.as_tensor(labels, dtype=torch.int64),
                            minlength=tr.m)]
    emit({"phase": "cold_start", "measure": measure, "n_pre": len(pre_idx),
          "d_w": tr.model_size, "group_sizes": sizes, "cold_ms": cold_ms})
    round_ms = []
    for t in range(ROUNDS):
        t1 = time.perf_counter()
        m = tr.round(t)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
        rec = {"phase": "round", "measure": measure, "t": t,
               "acc": m.weighted_acc, "loss": m.mean_loss,
               "disc": m.discrepancy, "cold": tr.last_cold,
               "round_ms": round_ms[-1]}
        emit(rec)
        for k in ("acc", "loss", "disc"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{measure} round {t}: {k} = {rec[k]}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "run", "measure": measure, "launches": counts,
          "cold_ms": cold_ms, "round_ms": round_ms,
          "peak_device_bytes": peak})
    return tr, pre_idx, counts


def breakdown(torch, tr, pre_idx):
    """Phase 5: the cold start's two parts, timed apart on the same
    pre-training cohort, and a round's local solve alone (host clock
    around work ending in synchronize)."""
    from repro_torch.core import measures
    from repro_torch.core.svd import OVERSAMPLE
    from repro_torch.models.modules import flatten_stacked

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (deltas, _, _), solve_ms = timed(lambda: tr._solve(tr.params, pre_idx))
    cohort = pre_idx[:tr.cfg.clients_per_round]
    _, round_solve_ms = timed(lambda: tr._solve(tr.params, cohort))
    dW = flatten_stacked(deltas)
    omega = tr.draws.svd_omega(len(pre_idx),
                               min(tr.m + OVERSAMPLE, len(pre_idx)), "cuda")
    _, edc_ms = timed(lambda: measures.edc_embed(dW, tr.m, omega))
    _, madc_ms = timed(lambda: measures.madc(
        measures.cosine_similarity_matrix(dW)))
    emit({"phase": "breakdown", "n_pre": len(pre_idx),
          "local_solver_ms": solve_ms, "k": len(cohort),
          "round_local_solver_ms": round_solve_ms, "edc_embed_ms": edc_ms,
          "cosine_plus_madc_ms": madc_ms,
          "note": "local solver is plain PyTorch (autograd); the kernels "
                  "sit inside edc_embed / madc"})


def round_profile(torch, tr):
    """Phase 5: one more round under torch.profiler: the device's busy
    share of the round's wall time (sum of kernel times over the host
    clock around the round), the kernel launches, and the kernels that
    take the most device time. ``None`` where the profiler records no
    device activity (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.round(len(tr.history.rounds))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    emit({"phase": "round_profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "kernel_launches": sum(e.count for e in kern) if kern else None,
          "top_kernels": [[e.key[:80], e.count,
                           e.self_device_time_total / 1e3] for e in top]})


def reference_check(torch):
    """Phase 3: the same tiny run on the CPU (plain versions) and on the
    card (kernels), with the same draws (TorchDraws uses a CPU generator):
    cold-start labels equal, losses and discrepancies within rtol 1e-3
    (float sums in another order over many SGD steps), accuracy within
    0.01 (argmax can flip at a near-tie)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedConfig
    from repro_torch.models.paper_models import mlp

    data = mnist_like(seed=0, n_clients=30, classes_per_client=2,
                      total_train=2000, dim=32)
    for measure in ("edc", "madc"):
        cfg = FedConfig(n_rounds=2, clients_per_round=8, local_epochs=2,
                        batch_size=10, lr=0.05, n_groups=3,
                        pretrain_scale=4, measure=measure, seed=0)
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = FedGroupTrainer(mlp(32, 16, 10), data, cfg, device=dev)
            runs[dev] = (tr.run(), tr.membership.copy())
        (hc, mc), (hg, mg) = runs["cpu"], runs["cuda"]
        ok = bool((mc == mg).all())
        for rc, rg in zip(hc.rounds, hg.rounds):
            ok &= math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
            ok &= math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
            ok &= abs(rc.weighted_acc - rg.weighted_acc) <= 0.01
        emit({"phase": "reference", "measure": measure, "ok": ok,
              "cpu": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                      for r in hc.rounds],
              "cuda": [[r.weighted_acc, r.mean_loss, r.discrepancy]
                       for r in hg.rounds]})
        if not ok:
            raise AssertionError(f"{measure}: card run disagrees with CPU")


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 3

    # phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "library": lib.name})

    # phase 2: kernels against their plain versions
    rows = check_kernels(torch)

    # phase 3: the port on the card agrees with the port on the CPU; this
    # tiny run is also the warm-up (first use of cuBLAS / cuSOLVER /
    # torch.func on the card), so the main path's times exclude it
    reference_check(torch)

    # phase 4: the main path at full width (FEMNIST MLP-512, paper Table 2)
    from repro_torch.data.generators import femnist_like
    from repro_torch.models.paper_models import mlp
    t0 = time.perf_counter()
    data = femnist_like(seed=0, dim=784, n_classes=26, n_clients=200)
    model = mlp(784, 512, 26)
    emit({"phase": "config", "dataset": "femnist_like(dim=784, "
          "n_classes=26, n_clients=200)", "model": "mlp(784, 512, 26)",
          "m": 5, "alpha": 20, "K": 20, "B": 10, "lr": 0.03, "E": 2,
          "rounds": ROUNDS, "data_s": time.perf_counter() - t0,
          "note": "E cut from the paper's 20 to 2 to fit the smoke's time "
                  "limit; weights random from seed 0"})
    tr_edc, pre_idx, counts_edc = fedgroup_run(torch, data, model, "edc")
    _, _, counts_madc = fedgroup_run(torch, data, model, "madc")
    if counts_edc["edc_cosine"] < 1:
        raise AssertionError("EDC run launched no edc_cosine kernel")
    if counts_madc["madc"] < 1:
        raise AssertionError("MADC run launched no madc kernel")

    # phase 5: where the time goes
    breakdown(torch, tr_edc, pre_idx)
    round_profile(torch, tr_edc)

    # phase 6: the kernels line and the result
    launches = {"edc_cosine": counts_edc["edc_cosine"]
                + counts_madc["edc_cosine"],
                "madc": counts_edc["madc"] + counts_madc["madc"]}
    src_of = {"edc_cosine": ("src/repro_torch/csrc/edc_cosine.cu",
                             "src/repro/kernels/edc_cosine.py:49"),
              "madc": ("src/repro_torch/csrc/madc.cu",
                       "src/repro/kernels/madc.py:78")}
    kernels = []
    for name in ops.KERNELS:
        row = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": src_of[name][0],
                        "replaces": src_of[name][1],
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
