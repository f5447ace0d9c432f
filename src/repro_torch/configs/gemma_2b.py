"""Gemma-2B — GeGLU, head_dim=256, MQA(kv=1), tied embeddings, embedding
scaling by sqrt(d_model). [arXiv:2403.08295]"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    mlp_act="geglu_gelu", mlp_gated=True, tie_embeddings=True,
    embed_scale=True, rope_theta=10000.0,
    source="arXiv:2403.08295",
)
