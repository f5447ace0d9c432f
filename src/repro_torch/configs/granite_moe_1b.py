"""Granite-3.0-1B-A400M — 32-expert top-8 MoE decoder.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, moe_d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8,
    mlp_act="silu", mlp_gated=True, rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
