"""The federated dry run (``repro.launch.fed_dryrun``): the paper's
technique at production size, on the reference's production mesh.

  round      one FedGroup round (``fed.parallel.make_parallel_round``):
             K = 1,024 clients, each E = 20 local epochs of the FEMNIST
             MLP (``mlp(784, 512, 62)``, paper Table 2), then per-group
             aggregation.
  coldstart  Algorithm 3 on an update matrix ΔW (n_pre = 64 × d_w), d_w =
             415,258,624 (the FEMNIST MLP scaled ×1000): randomized SVD,
             the EDC embedding E, one K-Means step from E's first m rows.
             ``--qr cholesky`` uses CholeskyQR2. E always comes from
             ``edc_cosine`` (the reference's ``--kernel``; its plain
             version off the card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --workload round
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --workload coldstart --qr cholesky
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --mesh 1   # no mesh

By default the CLI makes a ``fake`` process group of 256 ranks (512 with
``--multi-pod``) in its own process and runs rank 0's program on the
production mesh (``launch.mesh.make_production_mesh``: 16 × 16 as
("data", "model"), or 2 × 16 × 16 with a leading "pod"): the round with
its data slice's cohort rows and the rank's blocks of the group
parameters (``group_param_pspec``), the cold start with the rank's d_w
block of ΔW (``P(None, "model")``: 64 × 25,953,664 fp32, exactly
6,644,137,984 bytes on both meshes). A fake group's collectives move
nothing. ``--mesh 1`` runs the functions of one device, as before.

Each workload's (fn, args) is built on ``meta`` (shapes only: nothing is
allocated on any device) and run once under ``FlopCounterMode``, as
``launch/dryrun.py`` runs the zoo's steps; the record holds the argument
and output bytes a rank holds, its FLOPs and the ops counted, and on a
mesh the collective inventory: ``n_collectives``,
``collective_bytes_total`` and ``collective_bytes_by_kind`` (the bytes of
each collective's buffer on a rank), counted by ``torch.distributed
.tensor.debug.CommDebugMode`` and logged with their group and bytes by
the mesh (``FedMesh.comm_log``), which must agree;
``collectives_by_group`` splits them over the world, data and model
groups. FlopCounterMode counts no QR, SVD, Cholesky or triangular solve,
so the coldstart's FLOPs are its products only. On a real device
``run_round`` / ``run_coldstart`` build the same functions on real
tensors (``chip_smoke.py`` runs both on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.fed import parallel as fp
from repro_torch.fed.client import draw_batch_indices
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.modules import tree_leaves
from repro_torch.models.paper_models import mlp

D_W = 415_258_624          # the FEMNIST MLP (415,258 params) scaled ×1000
LR = 0.03
# what a record cannot give, as launch/dryrun.py's, and what is not ported
DIFFERENCES = dict(
    dryrun.DIFFERENCES,
    flops="only the ops FlopCounterMode knows (flops_by_op): no QR, SVD, "
          "Cholesky or triangular solve",
    kernel="no --kernel switch: E always comes from edc_cosine")
# what a production-mesh record differs in from the reference's HLO parse
MESH_DIFFERENCES = dict(
    DIFFERENCES,
    collectives="counted as the port issues them over NCCL (CommDebugMode "
                "and the mesh's log), not parsed from partitioned HLO: sums "
                "are all_reduces and gathers all_gathers (gloo would sum "
                "zero-filled buffers instead), and the round solves its rows "
                "with the group parameters gathered whole (XLA partitions "
                "the solver over 'model', with a collective a layer and "
                "step); bytes are each collective's output on a rank, loop "
                "trips not multiplied",
    flops="a rank's program (its cohort rows, its d_w block); only the ops "
          "FlopCounterMode knows: no QR, SVD, Cholesky or triangular solve",
    argument_size_in_bytes="a rank's inputs: its data slice's cohort rows, "
                           "its blocks of the group parameters, its ΔW "
                           "block")


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def run_round(device="meta", *, n_clients=1024, max_n=256, dim=784,
              n_groups=5, epochs=20, batch=10, mesh=None):
    """(fn, args) of one FedGroup round: fn(group_params, membership, X, Y,
    n, idx) -> (group params, global params, group deltas). On a real
    device the inputs are drawn from a CPU generator seeded 0 and copied
    there, so every device sees the same draws: m group models from
    ``mlp``'s init, clients in round-robin groups, X standard normal, Y
    uniform over the 62 classes, n uniform in [max_n / 2, max_n], and the
    minibatch rows. With a ``mesh`` (``meta`` only) fn is a rank's round
    and its args a rank's: X and Y its data slice's rows, the group
    parameters its blocks."""
    model = mlp(dim, 512, 62)                      # paper FEMNIST-MLP
    round_fn = fp.make_parallel_round(
        model, epochs=epochs, batch_size=batch, lr=LR, mu=0.0,
        n_groups=n_groups, max_samples=max_n, mesh=mesh)
    steps = round_fn.max_steps
    K = n_clients
    if torch.device(device).type == "meta":
        init = model.init(None, device="meta")
        gp = {k: _meta((n_groups,) + tuple(v.shape)) for k, v in init.items()}
        Kx = K
        if mesh is not None:
            layout = mesh_lib.param_layout(mesh, model)
            gp = gp if layout is None else layout.block(gp)
            lo, hi = mesh.cohort_rows(K) or (0, K)
            Kx = hi - lo
        args = (gp, _meta((K,), torch.int32), _meta((Kx, max_n, dim)),
                _meta((Kx, max_n), torch.int32), _meta((K,), torch.int32),
                _meta((K, steps, batch), torch.int64))
        return round_fn, args
    if mesh is not None:
        raise ValueError("run_round builds a rank's round on meta only")
    g = torch.Generator().manual_seed(0)
    inits = [model.init(g, device="cpu") for _ in range(n_groups)]
    gp = {k: torch.stack([p[k] for p in inits]) for k in inits[0]}
    membership = (torch.arange(K) % n_groups).to(torch.int32)
    X = torch.randn((K, max_n, dim), generator=g)
    Y = torch.randint(0, 62, (K, max_n), generator=g, dtype=torch.int32)
    n = torch.randint(max_n // 2, max_n + 1, (K,), generator=g,
                      dtype=torch.int32)
    idx = draw_batch_indices(n, steps, batch, g)
    args = ({k: v.to(device) for k, v in gp.items()}, membership.to(device),
            X.to(device), Y.to(device), n.to(device), idx.to(device))
    return round_fn, args


# ΔW's spectrum on a real device: m leading directions well above a tail,
# then noise (CQR2 squares the condition number, so it stays ~1e2)
SPECTRUM = (1.0, 0.8, 0.6, 0.5, 0.4, 0.05, 0.04, 0.03)
NOISE = 0.005


# columns of one product when ΔW is built: a block of whole chunks has the
# same shapes, so the same bits, as the whole matrix's columns
BUILD_CHUNK = 1 << 19


def decaying_update_matrix(n: int, d: int, device, cols=None
                           ) -> torch.Tensor:
    """(n, d) fp32 ΔW = U diag(SPECTRUM) G + NOISE · N, made on ``device``:
    U (n, r) orthonormal from a CPU generator, G (r, d) and N standard
    normal from a generator on the device, U diag(SPECTRUM) G as products
    of BUILD_CHUNK columns, N added 8 rows at a time (so the peak is ΔW, G
    and an (8, d) block). ``cols`` = (lo, hi) builds those columns only
    (a model-axis rank's d_w block), from the same whole draws: the whole
    matrix's columns bit for bit when lo and hi are multiples of
    BUILD_CHUNK (or d)."""
    lo, hi = (0, d) if cols is None else (int(cols[0]), int(cols[1]))
    r = len(SPECTRUM)
    cpu = torch.Generator().manual_seed(0)
    U = torch.linalg.qr(torch.randn((n, r), generator=cpu))[0]
    Us = (U * torch.tensor(SPECTRUM)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    G = torch.randn((r, d), generator=gen, device=device)
    dW = torch.empty((n, hi - lo), device=device)
    for c0 in range(lo - lo % BUILD_CHUNK, hi, BUILD_CHUNK):
        a, b = max(c0, lo), min(c0 + BUILD_CHUNK, hi)
        dW[:, a - lo:b - lo] = Us @ G[:, a:b]
    del G
    for i in range(0, n, 8):
        j = min(i + 8, n)
        dW[i:j].add_(torch.randn((j - i, d), generator=gen,
                                 device=device)[:, lo:hi], alpha=NOISE)
    return dW


def coldstart_step(m: int = 5, qr_impl: str = "householder", mesh=None):
    """fn(dW, omega) -> (assign, centers, E): Algorithm 3's EDC branch,
    then one ``kmeans_step`` from ``E[:m]``. With a model-axis ``mesh`` dW
    is this rank's d_w block."""
    def coldstart(dW, omega):
        E, _ = fp.edc_embedding_distributed(dW, m, omega=omega,
                                            qr_impl=qr_impl, mesh=mesh)
        assign, centers = fp.kmeans_step(E, E[:m])
        return assign, centers, E
    return coldstart


def run_coldstart(device="meta", *, n_pre=64, d_w=D_W, m=5,
                  qr_impl="householder", mesh=None):
    """(fn, args) of ``coldstart_step`` at scale. On a real device ΔW is
    ``decaying_update_matrix`` and Ω is drawn from a CPU generator seeded
    0. With a ``mesh`` (``meta`` only) ΔW is this rank's d_w block."""
    coldstart = coldstart_step(m, qr_impl, mesh)
    k = min(m + 8, n_pre)
    if torch.device(device).type == "meta":
        lo, hi = (0, d_w) if mesh is None else mesh.model_cols(d_w)
        return coldstart, (_meta((n_pre, hi - lo)), _meta((n_pre, k)))
    if mesh is not None:
        raise ValueError("run_coldstart builds a rank's program on meta "
                         "only")
    omega = torch.randn((n_pre, k), generator=torch.Generator().manual_seed(
        0))
    return coldstart, (decaying_update_matrix(n_pre, d_w, device),
                       omega.to(device))


def record(workload: str, fn, args, *, qr: str) -> dict:
    """The dry-run record of ``fn(*args)`` on ``meta``."""
    return {"workload": f"fedgroup_{workload}", "mesh": "1", "qr": qr,
            "status": "ok",
            "argument_shapes": [list(t.shape) for t in tree_leaves(args)],
            **dryrun.measure(fn, args, differences=DIFFERENCES)}


def mesh_record(workload: str, *, multi_pod: bool = False,
                qr: str = "householder", d_w: int = D_W) -> dict:
    """The record of rank 0's program of ``workload`` on the production
    mesh, inside a ``fake`` process group of 256 (512 with ``multi_pod``)
    ranks made here and destroyed at the end (``dryrun.fake_world``): the
    caller must hold no process group (the CLI runs in a process of its
    own)."""
    with dryrun.fake_world(multi_pod) as mesh:
        if workload == "round":
            fn, fargs = run_round(mesh=mesh)
        else:
            fn, fargs = run_coldstart(d_w=d_w, qr_impl=qr, mesh=mesh)
        rec = dryrun.measure_on_mesh(mesh, fn, fargs,
                                     differences=MESH_DIFFERENCES)
    return {"workload": f"fedgroup_{workload}", "mesh": rec.pop("mesh"),
            "axes": rec.pop("axes"), "qr": qr, "status": "ok",
            "argument_shapes": [list(t.shape) for t in tree_leaves(fargs)],
            **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("round", "coldstart"),
                    default="round")
    ap.add_argument("--mesh", choices=("production", "1"),
                    default="production",
                    help="the production mesh (16x16, or 2x16x16 with "
                         "--multi-pod) in a fake world, or 1: no mesh")
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--qr", choices=("householder", "cholesky"),
                    default="householder")
    ap.add_argument("--dw", type=int, default=D_W)
    ap.add_argument("--out", default=dryrun.OUT_DIR,
                    help="where the record lands (default "
                         "experiments/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.mesh == "1" and args.multi_pod:
        ap.error("--multi-pod runs on the production mesh, not --mesh 1")

    if args.mesh == "production":
        rec = mesh_record(args.workload, multi_pod=args.multi_pod,
                          qr=args.qr, d_w=args.dw)
    elif args.workload == "round":
        rec = record(args.workload, *run_round(), qr=args.qr)
    else:
        rec = record(args.workload, *run_coldstart(d_w=args.dw,
                                                   qr_impl=args.qr),
                     qr=args.qr)
    print(json.dumps(rec, indent=1))
    os.makedirs(args.out, exist_ok=True)
    tag = f"fedgroup_{args.workload}_{rec['mesh']}_{args.qr}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
