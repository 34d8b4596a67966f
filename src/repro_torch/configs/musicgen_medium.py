"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284].

Audio frontend (EnCodec + codebook interleaving) is a stub per the brief:
``input_specs`` supplies precomputed frame embeddings (B, S, d_model).
24 heads with kv=24 ⇒ full multi-head attention (no GQA grouping).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    mixer_pattern=("attn",),
    rope_theta=10_000.0,
    embeds_input=True,
    citation="arXiv:2306.05284",
    notes="long_500k runs with sliding_window=8192 (sub-quadratic carve-out).",
)
