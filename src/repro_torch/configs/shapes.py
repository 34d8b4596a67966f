"""Assigned input shapes.

Decode shapes lower ``serve_step`` (ONE new token against a KV cache of
``seq_len``); train/prefill lower full-sequence programs.  ``long_500k``
requires sub-quadratic attention: SSM/hybrid run natively; pure-attention
archs run with a sliding-window (8192) variant enabled for that shape only
(``configs.get(name, shape)``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

LONG_CONTEXT_WINDOW = 8_192  # sliding window enabled for long_500k on
                             # pure-attention architectures
