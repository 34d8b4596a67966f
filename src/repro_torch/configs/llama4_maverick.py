"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family]:
early-fusion VLM, 128 routed experts top-1, MoE interleaved every other layer
(interleave_moe_layer_step=2), d_ff=8192 dense and expert."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  every_k_layers=2, offset=1),
    mixer_pattern=("attn", "attn"),   # super-block of 2: dense FFN, then MoE
    rope_theta=500_000.0,
    embeds_input=True,          # early-fusion image patches via stub frontend
    citation="hf:meta-llama/Llama-4-Scout-17B-16E (family card)",
    notes="long_500k runs with sliding_window=8192 (Llama-4 itself uses "
          "chunked attention for long context).",
)
