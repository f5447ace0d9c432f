"""Assigned input shapes (``repro.configs.shapes``, the parts that are not
JAX): the four workload shapes, the long-context window, and which
(arch, shape) pairs run with which config.

  train_4k     seq_len=  4,096  global_batch=256   (training)
  prefill_32k  seq_len= 32,768  global_batch= 32   (inference prefill)
  decode_32k   seq_len= 32,768  global_batch=128   (inference decode: ONE new
                                                    token, KV cache of seq_len)
  long_500k    seq_len=524,288  global_batch=  1   (long-context decode)

``long_500k`` switches every arch with attention layers to a sliding window
of ``LONG_CONTEXT_WINDOW`` keys over a ring cache of as many slots. The JAX
package's ``batch_specs`` / ``decode_specs`` build stand-ins for its dry run
and come with it (ROADMAP.md queue 1, item 17g).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models import zoo


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Sliding window used by full-attention archs for long_500k.
LONG_CONTEXT_WINDOW = 8192


def supported(cfg: zoo.ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable, plus a reason when skipped."""
    if shape.kind == "decode" and cfg.family == "audio":
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, "native sub-quadratic"
        return True, f"sliding-window variant (window={LONG_CONTEXT_WINDOW})"
    return True, ""


def config_for(cfg: zoo.ArchConfig, shape: InputShape) -> zoo.ArchConfig:
    """Shape-adjusted config: long_500k switches attention to sliding-window
    for every arch that has attention layers."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.with_window(LONG_CONTEXT_WINDOW)
    return cfg
