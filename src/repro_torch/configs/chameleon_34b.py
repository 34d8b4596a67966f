"""Chameleon-34B: early-fusion mixed-modal decoder [arXiv:2405.09818].

VQ image tokens share the 65536 vocab with text; the vision tokenizer is a
stub — ``input_specs`` supplies precomputed patch/VQ embeddings.  Chameleon
uses QK-norm for training stability (§3.1 of the paper).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    qk_norm=True,
    rope_theta=10_000.0,
    embeds_input=True,
    citation="arXiv:2405.09818",
    notes="long_500k runs with sliding_window=8192 (sub-quadratic carve-out).",
)
