"""GLM-4-9B — dense decoder, RoPE, GQA(kv=2), SwiGLU. [hf:THUDM/glm-4-9b]"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552,
    mlp_act="silu", mlp_gated=True, qkv_bias=True, rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
)
