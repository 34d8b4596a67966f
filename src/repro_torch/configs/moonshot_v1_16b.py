"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: fine-grained MoE,
64 experts top-6, expert d_ff=1408 (assigned spec; ≈3.9B active params)."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="dense",            # assigned pool tags it dense; MoE FFN per spec
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408),
    rope_theta=50_000.0,
    citation="hf:moonshotai/Moonlight-16B-A3B",
    notes="every layer MoE (Moonlight uses dense layer 0; simplified). "
          "long_500k runs with sliding_window=8192.",
)
