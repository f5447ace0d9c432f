"""InternVL2-1B — Qwen2-0.5B language backbone + InternViT frontend (stub).
[arXiv:2404.16821]

As in the JAX package (``repro.configs.internvl2_1b``), the vision encoder
is a stub: the batch supplies pre-computed patch embeddings
(``batch["patch_embeds"]``, (B, 256, 1024)); the projector MLP and the
language decoder are implemented in full. Serving decodes text only.
"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    mlp_act="silu", mlp_gated=True, qkv_bias=True, rope_theta=1000000.0,
    frontend="vision", frontend_dim=1024, n_patches=256,
    source="arXiv:2404.16821",
)
