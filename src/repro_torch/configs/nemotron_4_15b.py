"""Nemotron-4-15B — dense decoder, GQA(kv=8), squared-ReLU MLP.
[arXiv:2402.16819]"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    mlp_act="relu2", mlp_gated=False, rope_theta=10000.0,
    source="arXiv:2402.16819",
)
