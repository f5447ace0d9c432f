"""Architecture registry (``repro.configs.registry``): ``--arch <id>``
resolution + reduced smoke variants, for the architectures ported so far.

Only Zamba2-1.2B (the hybrid family) is ported; any other name raises and
points at ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import zamba2_1p2b
from repro_torch.models.zoo import ArchConfig

ARCHS: dict[str, ArchConfig] = {c.CONFIG.name: c.CONFIG
                                for c in (zamba2_1p2b,)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch (ported: "
                       f"{sorted(ARCHS)}); the rest of the zoo is ROADMAP.md "
                       "queue 1, items 17b-17e")
    return ARCHS[name]


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant: 2 layers, d_model 256 (the JAX
    package's hybrid branch, ``registry.py:43-46``), for the CPU tests."""
    if cfg.family != "hybrid":
        raise KeyError(f"no smoke variant for the {cfg.family!r} family in "
                       "repro_torch yet (ROADMAP.md queue 1, items 17b-17e)")
    return dataclasses.replace(
        cfg, n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, lr=1e-2,
        n_heads=4, n_kv_heads=4, head_dim=64, ssm_head_dim=32, ssm_state=16,
        shared_attn_period=2, ssd_chunk=16)
