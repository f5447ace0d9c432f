"""DeepSeek-V3 671B — MLA attention + MoE (1 shared + 256 routed, top-8).
[arXiv:2412.19437]

Deviations (as in the JAX package): all 61 layers are MoE (the real model
keeps the first 3 dense); the MTP auxiliary head is available as the optional
``mtp`` example, not part of the core step.
"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, moe_d_ff=2048, vocab_size=129280,
    n_experts=256, top_k=8, n_shared_experts=1,
    mla=True, q_rank=1536, kv_rank=512, qk_nope=128, qk_rope=64,
    v_head_dim=128,
    mlp_act="silu", mlp_gated=True, rope_theta=10000.0,
    source="arXiv:2412.19437",
)
