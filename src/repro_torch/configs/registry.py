"""Architecture registry (``repro.configs.registry``): ``--arch <id>``
resolution + reduced smoke variants, every arch of the JAX package's
registry.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v3_671b, gemma_2b, glm4_9b,
                                 granite_20b, granite_moe_1b, hubert_xlarge,
                                 internvl2_1b, nemotron_4_15b, xlstm_350m,
                                 zamba2_1p2b)
from repro_torch.models.zoo import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (glm4_9b, granite_20b, deepseek_v3_671b, internvl2_1b,
              zamba2_1p2b, xlstm_350m, granite_moe_1b, gemma_2b,
              hubert_xlarge, nemotron_4_15b)
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts.

    Used by the per-arch CPU smoke tests (one forward/train step, assert
    shapes + no NaNs). Dim ratios keep each family's structural constraints
    (GQA divisibility, MoE top_k <= n_experts, SSD head divisibility...).
    """
    kw: dict = dict(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, lr=1e-2,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=128,
                  n_heads=4, n_kv_heads=2, head_dim=64)
        if cfg.mla:
            kw.update(q_rank=64, kv_rank=32, qk_nope=32, qk_rope=16,
                      v_head_dim=32)
    elif cfg.family == "hybrid":
        kw.update(n_heads=4, n_kv_heads=4, head_dim=64,
                  ssm_head_dim=32, ssm_state=16, shared_attn_period=2,
                  ssd_chunk=16)
    elif cfg.family == "ssm":
        kw.update(n_heads=4, xlstm_pattern=("m", "s"), xlstm_chunk=8, d_ff=0)
    elif cfg.family == "audio":
        kw.update(n_heads=4, n_kv_heads=4, head_dim=64, frontend_dim=64)
    elif cfg.family == "vlm":
        kw.update(n_heads=4, n_kv_heads=2, head_dim=64, frontend_dim=64,
                  n_patches=16)
    else:  # dense
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=64)
    return dataclasses.replace(cfg, **kw)
