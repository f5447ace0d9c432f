"""HuBERT-XLarge — encoder-only audio transformer (wav2vec2 arch).
[arXiv:2106.07447]

As in the JAX package (``repro.configs.hubert_xlarge``), the conv feature
extractor is a stub: the batch supplies frame embeddings
(``batch["frames"]``, (B, S, 512)). The transformer encoder (bidirectional
attention) and the frame-classification head are implemented in full. RoPE
stands in for the original conv positional embedding, as in the JAX
package. No decode step exists (encoder-only).
"""
from repro_torch.models.zoo import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    mlp_act="gelu", mlp_gated=False, causal=False, rope_theta=10000.0,
    frontend="audio", frontend_dim=512,
    source="arXiv:2106.07447",
)
