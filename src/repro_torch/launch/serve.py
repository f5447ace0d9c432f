"""Serving launcher: batched autoregressive decoding with a KV/state cache
(``repro.launch.serve``, flag for flag, plus ``--device``).

The prompt runs through ``serve_step`` one token at a time (the prefill),
then the loop decodes; the same line as the JAX launcher reports both
times. Weights are random from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --batch 4 --prompt-len 32 --gen 32               # gemma-2b, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --batch 4 --prompt-len 32 --gen 32           # xLSTM-350M whole
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --smoke              # MLA's compressed cache
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Every arch of the registry serves (DeepSeek-V3's 704 B params fit no card
whole: ``--smoke`` is its reduced variant). An encoder-only arch
(``hubert-xlarge``) prints that it has no decode step and exits 1, as the
JAX launcher does.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.models import zoo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32, dest="plen")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = registry.smoke_variant(cfg)
    if args.window:
        cfg = cfg.with_window(args.window)
    if not cfg.decode_supported:
        print(f"{cfg.name} is encoder-only: no decode step")
        return 1

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = zoo.init_params(gen, cfg, device=dev)
    B = args.batch
    max_len = args.plen + args.gen
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    prompts = torch.randint(0, cfg.vocab_size, (B, args.plen), generator=gen,
                            device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        # prefill through the decode path
        cache = zoo.init_cache(cfg, B, cache_len, device=dev)
        sync()
        t0 = time.perf_counter()
        logits = None
        for t in range(args.plen):
            logits, cache = zoo.serve_step(
                params, cfg, cache, prompts[:, t:t + 1],
                torch.full((B,), t, device=dev))
        sync()
        t_prefill = time.perf_counter() - t0

        toks = []
        t0 = time.perf_counter()
        last = prompts[:, -1:]
        for i in range(args.gen):
            pos = torch.full((B,), args.plen + i, device=dev)
            if i == 0:
                nxt = torch.argmax(logits, -1)[:, None]
            else:
                logits, cache = zoo.serve_step(params, cfg, cache, last,
                                               pos - 1)
                if args.temperature > 0:
                    probs = torch.softmax(logits.float() / args.temperature,
                                          dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=gen)
                else:
                    nxt = torch.argmax(logits, -1)[:, None]
            toks.append(nxt)
            last = nxt
        sync()
        t_gen = time.perf_counter() - t0

    out = torch.cat(toks, 1).cpu()
    print(f"# served {cfg.name}: batch={B} prompt={args.plen} gen={args.gen}"
          f" device={dev.type}")
    print(f"prefill {t_prefill*1e3:.1f}ms  decode {t_gen*1e3:.1f}ms "
          f"({args.gen * B / max(t_gen, 1e-9):.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"seq[{b}]: {out[b, :16].tolist()} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
