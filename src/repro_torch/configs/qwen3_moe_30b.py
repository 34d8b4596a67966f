"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8, QK-norm,
expert d_ff=768 (fine-grained)."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, vocab=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    qk_norm=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-30B-A3B",
    notes="long_500k runs with sliding_window=8192 (sub-quadratic carve-out).",
)
