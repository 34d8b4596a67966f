"""Architecture registry: the 10 assigned architectures (+ the paper's own
small models, which live in ``models.small``).  Data-only copies of
``repro.configs``.

``get(name)`` returns the exact assigned config; ``get(name, shape)`` applies
per-shape adaptations (sliding-window carve-out for long_500k on
pure-attention archs).
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MoEConfig
from .shapes import LONG_CONTEXT_WINDOW, SHAPES, InputShape

from . import (chameleon_34b, internlm2_1_8b, jamba_1_5_large, llama3_2_1b,
               llama4_maverick, moonshot_v1_16b, musicgen_medium,
               phi4_mini_3_8b, qwen3_moe_30b, xlstm_125m)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        musicgen_medium, jamba_1_5_large, xlstm_125m, chameleon_34b,
        llama3_2_1b, internlm2_1_8b, moonshot_v1_16b, phi4_mini_3_8b,
        qwen3_moe_30b, llama4_maverick,
    )
}

ALIASES = {
    "musicgen-medium": "musicgen-medium",
    "jamba-1.5-large-398b": "jamba-1.5-large-398b",
    "xlstm-125m": "xlstm-125m",
    "chameleon-34b": "chameleon-34b",
    "llama3.2-1b": "llama3.2-1b",
    "internlm2-1.8b": "internlm2-1.8b",
    "moonshot-v1-16b-a3b": "moonshot-v1-16b-a3b",
    "phi4-mini-3.8b": "phi4-mini-3.8b",
    "qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
}


def names() -> list[str]:
    return list(REGISTRY)


def get(name: str, shape: str | InputShape | None = None) -> ArchConfig:
    cfg = REGISTRY[ALIASES.get(name, name)]
    if shape is None:
        return cfg
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.name == "long_500k" and "attn" in cfg.mixer_pattern \
            and cfg.family not in ("ssm", "hybrid") \
            and cfg.sliding_window is None:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


__all__ = ["ArchConfig", "MoEConfig", "InputShape", "SHAPES", "REGISTRY",
           "get", "names", "LONG_CONTEXT_WINDOW"]
