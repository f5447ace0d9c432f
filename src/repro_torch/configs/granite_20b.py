"""Granite-20B-Code — dense decoder, llama-style, MQA(kv=1). [arXiv:2405.04324]"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_act="silu", mlp_gated=True, rope_theta=10000.0,
    source="arXiv:2405.04324",
)
