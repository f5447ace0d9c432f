"""Assigned input shapes (``repro.configs.shapes``, the parts that are not
JAX): the four workload shapes, the long-context window, and which
(arch, shape) pairs run with which config.

  train_4k     seq_len=  4,096  global_batch=256   (training)
  prefill_32k  seq_len= 32,768  global_batch= 32   (inference prefill)
  decode_32k   seq_len= 32,768  global_batch=128   (inference decode: ONE new
                                                    token, KV cache of seq_len)
  long_500k    seq_len=524,288  global_batch=  1   (long-context decode)

``long_500k`` switches every arch with attention layers to a sliding window
of ``LONG_CONTEXT_WINDOW`` keys over a ring cache of as many slots.

``batch_specs`` / ``decode_specs`` return the inputs of a workload as
``meta`` tensors, the reference's ``ShapeDtypeStruct`` stand-ins: shapes
and dtypes, and nothing allocated on any device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: zoo.ArchConfig, shape: InputShape) -> dict:
    """``meta`` tensors of a train / prefill batch: audio ``frames`` and
    ``labels``; a VLM's ``tokens`` and ``labels`` of S − n_patches text
    positions after its ``patch_embeds``; else ``tokens`` and ``labels``
    (int32, as the reference's)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"frames": _meta((B, S, cfg.frontend_dim), cfg.act_dtype),
                "labels": _meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        S_txt = S - cfg.n_patches
        return {"tokens": _meta((B, S_txt), torch.int32),
                "patch_embeds": _meta((B, cfg.n_patches, cfg.frontend_dim),
                                      cfg.act_dtype),
                "labels": _meta((B, S_txt), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32)}


def cache_len(cfg: zoo.ArchConfig, shape: InputShape) -> int:
    """Slots of a decode cache: seq_len, or with a window a ring of
    ``window`` slots (the point of the sliding-window variant)."""
    if cfg.window is not None:
        return min(shape.seq_len, cfg.window)
    return shape.seq_len


def decode_specs(cfg: zoo.ArchConfig, shape: InputShape) -> dict:
    """``meta`` tensors of one ``serve_step``: ``tokens`` (B, 1), ``pos``
    (B,) and the ``cache`` of ``cache_len`` slots."""
    B = shape.global_batch
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((B,), torch.int32),
            "cache": zoo.init_cache(cfg, B, cache_len(cfg, shape),
                                    device="meta")}


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
