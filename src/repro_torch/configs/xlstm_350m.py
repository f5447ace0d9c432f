"""xLSTM-350M — mLSTM blocks with sLSTM blocks interleaved. [arXiv:2405.04517]

d_ff=0 per the assignment: mLSTM blocks carry their own 2x up-projection and
sLSTM blocks a 4/3 gated post-FFN, so there is no standalone transformer FFN.
"""
from repro_torch.models.zoo import ArchConfig

_pattern = tuple("s" if i in (5, 11, 17, 23) else "m" for i in range(24))

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_pattern=_pattern, mlstm_proj_factor=2, xlstm_chunk=32,
    source="arXiv:2405.04517",
)
