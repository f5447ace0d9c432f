"""Training launcher of the PyTorch/CUDA port: ``--mode fed``, federated
training on the synthetic federated datasets (``repro.launch.train``'s
fed flags and datasets, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --mode fed \
      --framework fedgroup --dataset femnist --rounds 30

Frameworks: fedavg, fedprox, fedgroup, fedgrouprox, ifca, fesem. Runs on
``cuda`` unless ``--device cpu``. ``--async-depth D`` (with
``--async-alpha`` / ``--async-beta``) runs the async runtime with D
dispatches in flight; ``--async-depth 1`` prints the synchronous run's
``acc=`` / ``disc=`` lines exactly. ``--telemetry-dir DIR`` traces the run
and streams its round records into DIR (``metrics.jsonl``, ``trace.json``,
``run_summary.json``), which ``python -m repro_torch.launch.inspect DIR``
renders. Not yet ported (it raises): ``--mode lm``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_fed(args) -> int:
    from repro_torch.checkpoint import save_pytree
    from repro_torch.core.fedgroup import FedGrouProxTrainer, FedGroupTrainer
    from repro_torch.data import generators as gen
    from repro_torch.fed.engine import (FedAvgTrainer, FedConfig,
                                        FedProxTrainer)
    from repro_torch.fed.fesem import FeSEMTrainer
    from repro_torch.fed.ifca import IFCATrainer
    from repro_torch.fed.server import tree_index
    from repro_torch.models.paper_models import lstm_classifier, mclr, mlp

    datasets = {
        "mnist": lambda: (gen.mnist_like(args.seed,
                                         n_clients=args.clients or 1000,
                                         classes_per_client=2,
                                         total_train=20000, dim=128),
                          mclr(128, 10)),
        "mnist_mlp": lambda: (gen.mnist_like(args.seed,
                                             n_clients=args.clients or 1000,
                                             classes_per_client=2,
                                             total_train=20000, dim=128),
                              mlp(128, 128, 10)),
        "femnist": lambda: (gen.femnist_like(args.seed,
                                             n_clients=args.clients or 200,
                                             total_train=15000, dim=128),
                            mlp(128, 128, 62)),
        "synthetic": lambda: (gen.synthetic(1.0, 1.0, args.seed,
                                            n_clients=args.clients or 100),
                              mclr(60, 10)),
        "sent140": lambda: (gen.sent140_like(args.seed,
                                             n_clients=args.clients or 300,
                                             total_train=10000, vocab=400),
                            lstm_classifier(400, 16, 32)),
    }
    frameworks = {"fedavg": FedAvgTrainer, "fedprox": FedProxTrainer,
                  "fedgroup": FedGroupTrainer,
                  "fedgrouprox": FedGrouProxTrainer,
                  "ifca": IFCATrainer, "fesem": FeSEMTrainer}
    if args.framework not in frameworks:
        raise ValueError(f"unknown framework {args.framework!r}")
    data, model = datasets[args.dataset]()
    cfg = FedConfig(n_rounds=args.rounds, clients_per_round=args.k,
                    local_epochs=args.epochs, batch_size=args.batch,
                    lr=args.lr, mu=args.mu, n_groups=args.groups,
                    pretrain_scale=args.alpha, eta_g=args.eta_g,
                    measure=args.measure, seed=args.seed,
                    async_depth=args.async_depth,
                    async_alpha=args.async_alpha, async_beta=args.async_beta,
                    telemetry_dir=args.telemetry_dir)
    tr = frameworks[args.framework](model, data, cfg, device=args.device)
    print(f"# {args.framework} on {data.name} ({tr.device}): "
          f"{data.n_clients} clients, m={cfg.n_groups}, "
          f"K={cfg.clients_per_round}, E={cfg.local_epochs}"
          + (f", async_depth={cfg.async_depth}" if cfg.async_depth else ""))
    t0 = time.time()
    if cfg.async_depth:
        # the async loop folds inside run(): the per-fold lines come after
        tr.run(cfg.n_rounds)
        for t, m in enumerate(tr.history.rounds):
            print(f"round {t:3d} acc={m.weighted_acc:.4f} "
                  f"disc={m.discrepancy:.4f}")
        st = tr.history.async_stats
        print(f"async: folds={st['folds']} "
              f"max_in_flight={st['max_in_flight']} "
              f"staleness={st['staleness_hist']} ({time.time()-t0:.1f}s)")
    else:
        for t in range(cfg.n_rounds):
            m = tr.round(t)
            print(f"round {t:3d} acc={m.weighted_acc:.4f} "
                  f"disc={m.discrepancy:.4f} ({time.time()-t0:.1f}s)")
    print(f"max_acc={tr.history.max_acc:.4f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        params = (tree_index(tr.group_params, 0)
                  if hasattr(tr, "group_params") else tr.params)
        save_pytree(os.path.join(args.out, "model.npz"), params,
                    {"framework": args.framework, "dataset": args.dataset,
                     "max_acc": tr.history.max_acc})
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump([r.__dict__ for r in tr.history.rounds], f, indent=1)
        print(f"saved to {args.out}")
    tr.close()          # flush telemetry (trace.json + run_summary.json)
    if args.telemetry_dir:
        print(f"telemetry in {args.telemetry_dir} — render with "
              f"python -m repro_torch.launch.inspect {args.telemetry_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("fed", "lm"), default="fed")
    ap.add_argument("--framework", default="fedgroup")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--mu", type=float, default=0.0)
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--alpha", type=int, default=20)
    ap.add_argument("--eta-g", type=float, default=0.0, dest="eta_g")
    ap.add_argument("--measure", choices=("edc", "madc"), default="edc")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--async-depth", type=int, default=0, dest="async_depth",
                    help="D>0 keeps D in-flight cohort dispatches, folded "
                         "with FedAsync staleness weights (0 = synchronous)")
    ap.add_argument("--async-alpha", type=float, default=1.0,
                    dest="async_alpha")
    ap.add_argument("--async-beta", type=float, default=0.0,
                    dest="async_beta")
    ap.add_argument("--telemetry-dir", default=None, dest="telemetry_dir",
                    help="trace the run and stream per-round records "
                         "into this dir (render with python -m "
                         "repro_torch.launch.inspect DIR)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError("--mode lm (the model zoo) is not yet "
                                  "ported to repro_torch (ROADMAP.md)")
    return run_fed(args)


if __name__ == "__main__":
    sys.exit(main())
