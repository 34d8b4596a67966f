"""xLSTM-125M: alternating mLSTM/sLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own projections (no separate FFN).
1:1 mLSTM:sLSTM interleave (the paper's 125M config mixes both kinds).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    mixer_pattern=("mlstm", "slstm"),
    citation="arXiv:2405.04517",
    notes="long_500k native: recurrent state is O(1) in sequence length.",
)
