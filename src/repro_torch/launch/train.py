"""Training launcher of the PyTorch/CUDA port: ``--mode fed``, federated
training on the synthetic federated datasets, and ``--mode lm``, language-
model training of a zoo arch (``repro.launch.train``'s flags and
datasets, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --mode fed \
      --framework fedgroup --dataset femnist --rounds 30
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch zamba2-1.2b --smoke --steps 10 --seq 128 --batch 4

Frameworks: fedavg, fedprox, fedgroup, fedgrouprox, ifca, fesem. Runs on
``cuda`` unless ``--device cpu``. ``--async-depth D`` (with
``--async-alpha`` / ``--async-beta``) runs the async runtime with D
dispatches in flight; ``--async-depth 1`` prints the synchronous run's
``acc=`` / ``disc=`` lines exactly. ``--telemetry-dir DIR`` traces the run
and streams its round records into DIR (``metrics.jsonl``, ``trace.json``,
``run_summary.json``), which ``python -m repro_torch.launch.inspect DIR``
renders.

Under torchrun (``WORLD_SIZE`` > 1) ``--mode fed`` runs on a data mesh of
the world's ranks (``launch.mesh``): the process group's backend is NCCL
when each rank has a card of its own, gloo when ranks share one or run
on the CPU; every rank trains its block of each cohort's clients, and
rank 0 alone prints and writes ``--out`` and ``--telemetry-dir``;
``--async-depth`` runs the async runtime on the mesh:

  torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \
      --mode fed --device cpu --framework fedgroup --dataset synthetic \
      --async-depth 1 --telemetry-dir tel

``--checkpoint-dir DIR`` writes an archive into DIR after every round, in
the reference's layout; ``--resume`` first restores DIR's latest archive
and runs the rounds left of ``--rounds`` (the rounds before it are not
printed again).

``--model-axis M`` (default ``REPRO_MODEL_AXIS``, else 1) makes it the 2-D
``(world / M, M)`` mesh: the group parameters sharded over M ranks
(``launch.mesh.ParamLayout``), each data slice's clients split over them;
``--out`` gathers the model on every rank and rank 0 writes it. The
runtime services run on it too: ``--checkpoint-dir`` / ``--resume`` (an
archive of whole leaves, resumable on any mesh shape), ``--telemetry-dir``
(rank 0 writes) and ``--async-depth``:

  torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train \
      --mode fed --device cpu --framework fedgroup --dataset synthetic \
      --model-axis 2 --checkpoint-dir ckpt --telemetry-dir tel

``--mode lm`` (``--arch``, default gemma-2b; ``--smoke`` for the reduced
same-family variant; ``--steps``, ``--seq``, ``--batch``) trains from
random weights on uniform random tokens, drawn in that order from one
``torch.Generator`` on the device seeded by ``--seed``, with
``zoo.train_step`` (AdamW). An
audio arch also gets random frames and a VLM random patch embeddings (the
reference's batch has tokens only, which those two families cannot
read). It prints the reference's step lines; ``--out DIR`` writes
``DIR/state.npz`` (params, ``mu``, ``nu``, ``step``) with ``{"arch",
"steps"}``, in the reference's archive format.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_fed(args) -> int:
    from repro_torch.launch import mesh as mesh_lib
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return _run_fed(args, print)
    mesh_lib.init_process_group(args.device)
    try:
        import torch.distributed as dist
        say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        return _run_fed(args, say)
    finally:
        mesh_lib.destroy_process_group()


def _run_fed(args, say) -> int:
    """``--mode fed`` with ``say`` for print (a no-op on ranks > 0, which
    also write nothing)."""
    from repro_torch.checkpoint import save_pytree
    from repro_torch.core.fedgroup import FedGrouProxTrainer, FedGroupTrainer
    from repro_torch.data import generators as gen
    from repro_torch.fed.engine import (FedAvgTrainer, FedConfig,
                                        FedProxTrainer)
    from repro_torch.fed.fesem import FeSEMTrainer
    from repro_torch.fed.ifca import IFCATrainer
    from repro_torch.fed.parallel import default_fed_mesh
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
                    telemetry_dir=args.telemetry_dir,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=1 if args.checkpoint_dir else 0)
    mesh = default_fed_mesh(args.model_axis, device=args.device)
    tr = frameworks[args.framework](model, data, cfg, device=args.device,
                                    mesh=mesh)
    t_start = 0
    if args.resume:
        if not args.checkpoint_dir:
            raise ValueError("--resume needs --checkpoint-dir")
        t_start = tr.load_checkpoint(args.checkpoint_dir)
    say(f"# {args.framework} on {data.name} ({tr.device}): "
          f"{data.n_clients} clients, m={cfg.n_groups}, "
          f"K={cfg.clients_per_round}, E={cfg.local_epochs}"
          + (f", async_depth={cfg.async_depth}" if cfg.async_depth else ""))
    t0 = time.time()
    if args.resume:
        say(f"resumed from {args.checkpoint_dir} after round {t_start}")
    if cfg.async_depth:
        # the async loop folds inside run(): the per-fold lines come after
        tr.run(max(cfg.n_rounds - t_start, 0))
        for t, m in enumerate(tr.history.rounds[t_start:], t_start):
            say(f"round {t:3d} acc={m.weighted_acc:.4f} "
                f"disc={m.discrepancy:.4f}")
        st = tr.history.async_stats
        say(f"async: folds={st['folds']} "
              f"max_in_flight={st['max_in_flight']} "
              f"staleness={st['staleness_hist']} ({time.time()-t0:.1f}s)")
    else:
        for t in range(t_start, cfg.n_rounds):
            m = tr.round(t)
            tr._maybe_checkpoint(t, t + 1)
            say(f"round {t:3d} acc={m.weighted_acc:.4f} "
                f"disc={m.discrepancy:.4f} ({time.time()-t0:.1f}s)")
    say(f"max_acc={tr.history.max_acc:.4f}")
    # whole on every rank (a gather over a model axis), written by rank 0
    params = None if not args.out else (
        tr.group_param(0) if hasattr(tr, "group_params")
        else tr.model_params())
    if args.out and (tr.mesh is None or tr.mesh.rank == 0):
        os.makedirs(args.out, exist_ok=True)
        save_pytree(os.path.join(args.out, "model.npz"), params,
                    {"framework": args.framework, "dataset": args.dataset,
                     "max_acc": tr.history.max_acc})
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump([r.__dict__ for r in tr.history.rounds], f, indent=1)
        say(f"saved to {args.out}")
    tr.close()          # flush telemetry (trace.json + run_summary.json)
    if args.telemetry_dir:
        say(f"telemetry in {args.telemetry_dir} — render with "
              f"python -m repro_torch.launch.inspect {args.telemetry_dir}")
    return 0


def lm_batch(gen, cfg, B: int, S: int, device) -> dict:
    """Uniform random tokens (B, S + 1) from ``gen``: inputs the first S,
    labels the last S; an audio arch's frames (B, S, frontend_dim) and a
    VLM's ``n_patches`` patch embeddings, standard normal."""
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, S, cfg.frontend_dim),
                                      generator=gen, device=device)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.frontend_dim), generator=gen,
            device=device)
    return batch


def run_lm(args) -> int:
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.models.modules import param_count

    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = registry.smoke_variant(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = zoo.init_train_state(gen, cfg, device=device)
    print(f"# LM training {cfg.name} ({'smoke' if args.smoke else 'full'}): "
          f"{param_count(state['params']):,} params")
    t0 = time.time()
    for step in range(args.steps):
        batch = lm_batch(gen, cfg, args.batch, args.seq, device)
        state, metrics = zoo.train_step(state, batch, cfg)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"({time.time()-t0:.1f}s)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_pytree(os.path.join(args.out, "state.npz"), state,
                    {"arch": cfg.name, "steps": args.steps})
        print(f"saved to {args.out}")
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
    ap.add_argument("--model-axis", type=int, default=None,
                    dest="model_axis",
                    help="under torchrun: shard the group parameters over "
                         "M ranks, a (world / M, M) mesh (default "
                         "REPRO_MODEL_AXIS, else 1)")
    ap.add_argument("--checkpoint-dir", default=None,
                    dest="checkpoint_dir",
                    help="write an archive here after every round (the "
                         "latest is what --resume restores)")
    ap.add_argument("--resume", action="store_true",
                    help="restore --checkpoint-dir's latest archive first")
    ap.add_argument("--telemetry-dir", default=None, dest="telemetry_dir",
                    help="trace the run and stream per-round records "
                         "into this dir (render with python -m "
                         "repro_torch.launch.inspect DIR)")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    return run_fed(args) if args.mode == "fed" else run_lm(args)


if __name__ == "__main__":
    sys.exit(main())
