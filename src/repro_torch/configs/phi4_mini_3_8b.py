"""Phi-4-mini-3.8B [arXiv:2412.08905]: RoPE, SwiGLU, GQA kv=8, 200k vocab,
tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    rope_theta=10_000.0,
    tie_embeddings=True,
    citation="arXiv:2412.08905",
    notes="long_500k runs with sliding_window=8192 (sub-quadratic carve-out).",
)
