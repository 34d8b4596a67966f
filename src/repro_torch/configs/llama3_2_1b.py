"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: RoPE-500k, SwiGLU, GQA kv=8,
tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    citation="hf:meta-llama/Llama-3.2-1B",
    notes="long_500k runs with sliding_window=8192 (sub-quadratic carve-out).",
)
