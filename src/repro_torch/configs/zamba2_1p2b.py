"""Zamba2-1.2B — Mamba2 backbone + shared attention block. [arXiv:2411.15242]

38 Mamba2 layers; one weight-shared attention+MLP block is applied every 6
layers (each application keeps its own KV cache at decode time). The real
model concatenates original embeddings into the shared block and adds LoRA
per application; like the JAX package (``repro.configs.zamba2_1p2b``),
the shared block is applied on the residual stream directly.
"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_period=6,
    mlp_act="silu", mlp_gated=True, rope_theta=10000.0,
    source="arXiv:2411.15242",
)
