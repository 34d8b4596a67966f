"""Jamba-1.5-Large: hybrid Mamba+attention 1:7 with MoE [arXiv:2403.19887].

Super-block of 8 layers with the attention layer at index 4 (as in the Jamba
block structure); MoE (16 experts, top-2) on every other layer.  Computed
total ≈ 398B params, matching the model card.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  every_k_layers=2, offset=1),
    mixer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    rope_theta=10_000.0,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    citation="arXiv:2403.19887",
    notes="attention layers attend full-context; Mamba carries long range. "
          "long_500k is native (SSM state is O(1); 9 attn layers' 500k KV "
          "cache at batch=1 is 19.3 GB over the pod).",
)
