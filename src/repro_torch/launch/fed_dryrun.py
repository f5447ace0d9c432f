"""The federated dry run without a mesh (``repro.launch.fed_dryrun`` less
the mesh): the paper's technique at production size.

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

Each workload's (fn, args) is built on ``meta`` (shapes only: nothing is
allocated on any device) and run once under ``FlopCounterMode``, as
``launch/dryrun.py`` runs the zoo's steps; the record holds the argument
and output bytes, the FLOPs and the ops counted. FlopCounterMode counts
no QR, SVD, Cholesky or triangular solve, so the coldstart's FLOPs are
its products only. On a real device ``run_round`` / ``run_coldstart``
build the same functions on real tensors (``chip_smoke.py`` runs both on
the card).

Not yet ported (ROADMAP.md queue 1): the (data, model) mesh, with
``--multi-pod`` (raises) and the d_w-sharded cold start (16c), and the
collective inventory (16d). The synchronous trainers' 1-D data mesh is
``launch/mesh.py`` (16a).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.fed import parallel as fp
from repro_torch.fed.client import draw_batch_indices
from repro_torch.launch import dryrun
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


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def run_round(device="meta", *, n_clients=1024, max_n=256, dim=784,
              n_groups=5, epochs=20, batch=10):
    """(fn, args) of one FedGroup round: fn(group_params, membership, X, Y,
    n, idx) -> (group params, global params, group deltas). On a real
    device the inputs are drawn from a CPU generator seeded 0 and copied
    there, so every device sees the same draws: m group models from
    ``mlp``'s init, clients in round-robin groups, X standard normal, Y
    uniform over the 62 classes, n uniform in [max_n / 2, max_n], and the
    minibatch rows."""
    model = mlp(dim, 512, 62)                      # paper FEMNIST-MLP
    round_fn = fp.make_parallel_round(
        model, epochs=epochs, batch_size=batch, lr=LR, mu=0.0,
        n_groups=n_groups, max_samples=max_n)
    steps = round_fn.max_steps
    K = n_clients
    if torch.device(device).type == "meta":
        gp = {k: _meta((n_groups,) + tuple(v.shape))
              for k, v in model.init(None, device="meta").items()}
        args = (gp, _meta((K,), torch.int32), _meta((K, max_n, dim)),
                _meta((K, max_n), torch.int32), _meta((K,), torch.int32),
                _meta((K, steps, batch), torch.int64))
        return round_fn, args
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


def decaying_update_matrix(n: int, d: int, device) -> torch.Tensor:
    """(n, d) fp32 ΔW = U diag(SPECTRUM) G + NOISE · N, made on ``device``:
    U (n, r) orthonormal from a CPU generator, G (r, d) and N standard
    normal from a generator on the device, N added 8 rows at a time (so
    the peak is ΔW plus two (8, d) blocks)."""
    r = len(SPECTRUM)
    cpu = torch.Generator().manual_seed(0)
    U = torch.linalg.qr(torch.randn((n, r), generator=cpu))[0]
    Us = (U * torch.tensor(SPECTRUM)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    G = torch.randn((r, d), generator=gen, device=device)
    dW = Us @ G
    del G
    for i in range(0, n, 8):
        j = min(i + 8, n)
        dW[i:j].add_(torch.randn((j - i, d), generator=gen, device=device),
                     alpha=NOISE)
    return dW


def coldstart_step(m: int = 5, qr_impl: str = "householder"):
    """fn(dW, omega) -> (assign, centers, E): Algorithm 3's EDC branch,
    then one ``kmeans_step`` from ``E[:m]``."""
    def coldstart(dW, omega):
        E, _ = fp.edc_embedding_distributed(dW, m, omega=omega,
                                            qr_impl=qr_impl)
        assign, centers = fp.kmeans_step(E, E[:m])
        return assign, centers, E
    return coldstart


def run_coldstart(device="meta", *, n_pre=64, d_w=D_W, m=5,
                  qr_impl="householder"):
    """(fn, args) of ``coldstart_step`` at scale. On a real device ΔW is
    ``decaying_update_matrix`` and Ω is drawn from a CPU generator seeded
    0."""
    coldstart = coldstart_step(m, qr_impl)
    k = min(m + 8, n_pre)
    if torch.device(device).type == "meta":
        return coldstart, (_meta((n_pre, d_w)), _meta((n_pre, k)))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("round", "coldstart"),
                    default="round")
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--qr", choices=("householder", "cholesky"),
                    default="householder")
    ap.add_argument("--dw", type=int, default=D_W)
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod (the 2x16x16 multi-pod mesh) is not yet ported to "
            "repro_torch: ROADMAP.md queue 1, item 16c (the 2-D (data, "
            "model) layout)")

    if args.workload == "round":
        fn, fargs = run_round()
    else:
        fn, fargs = run_coldstart(d_w=args.dw, qr_impl=args.qr)
    rec = record(args.workload, fn, fargs, qr=args.qr)
    print(json.dumps(rec, indent=1))
    os.makedirs(dryrun.OUT_DIR, exist_ok=True)
    tag = f"fedgroup_{args.workload}_1_{args.qr}"
    with open(os.path.join(dryrun.OUT_DIR, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
