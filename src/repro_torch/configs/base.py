"""Architecture configuration schema (a copy of ``repro.configs.base``).

Every assigned architecture is expressed as an ``ArchConfig``:

* ``mixer_pattern`` — the repeating sequence of sequence-mixer kinds
  ("attn" | "mamba" | "mlstm" | "slstm"), cycled over layers in
  *super-blocks* of ``len(mixer_pattern)`` layers.  The port runs the
  layers one after another (``nn.ModuleList``); the super-block is kept
  because the layer plan and the JAX param tree are laid out by it.
* ``moe`` — optional mixture-of-experts FFN replacing the dense FFN on layers
  with ``layer_idx % moe.every_k_layers == moe.offset``.
* ``embeds_input`` — audio/vlm frontends are stubs: training consumes
  precomputed frame/patch embeddings of shape (B, S, d_model).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    moe: MoEConfig | None = None
    mixer_pattern: tuple[str, ...] = ("attn",)
    rope_theta: float = 500_000.0
    qk_norm: bool = False
    sliding_window: int | None = None   # if set, attention is windowed
    embeds_input: bool = False          # audio/vlm stub frontend
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    citation: str = ""
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def __post_init__(self):
        if self.n_layers % len(self.mixer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"super-block size {len(self.mixer_pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.mixer_pattern)

    def ffn_kind(self, layer_idx: int) -> str:
        """FFN kind for absolute layer index: 'moe' | 'dense' | 'none'."""
        if self.moe is not None and \
                layer_idx % self.moe.every_k_layers == self.moe.offset:
            return "moe"
        if self.d_ff > 0:
            return "dense"
        return "none"

    def layer_plan(self) -> list[tuple[str, str]]:
        """[(mixer, ffn)] for one super-block (layer indices 0..sb-1 repeat)."""
        sb = len(self.mixer_pattern)
        if self.moe is not None and sb % self.moe.every_k_layers != 0:
            # ensure the ffn pattern is periodic with the super-block
            raise ValueError(f"{self.name}: moe.every_k_layers must divide "
                             f"super-block size {sb}")
        return [(self.mixer_pattern[i], self.ffn_kind(i)) for i in range(sb)]

    def reduced(self, layers: int = 2, d_model: int = 256, n_heads: int = 4,
                n_kv_heads: int | None = None, d_ff: int | None = None,
                experts: int = 4, vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny sizes (≤2 super-blocks)."""
        sb = len(self.mixer_pattern)
        layers = max(sb, (layers // sb) * sb)
        kv = n_kv_heads or min(n_heads, max(1, self.n_kv_heads * n_heads
                                            // max(self.n_heads, 1)))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(experts, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=d_model // 2)
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=layers, d_model=d_model,
            n_heads=n_heads, n_kv_heads=kv, head_dim=0,
            d_ff=(d_model * 2 if self.d_ff > 0 else 0) if d_ff is None else d_ff,
            vocab=vocab, moe=moe,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            dtype="float32")
