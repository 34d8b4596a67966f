"""Generic decoder stack: embed → layers → norm → logits.  Counterpart of
``repro.models.transformer``: the ``attn``, ``mamba``, ``mlstm`` and
``slstm`` mixers and the dense SwiGLU and ``moe`` FFNs.

:class:`Transformer` is an ``nn.Module`` whose layers are an
``nn.ModuleList`` of :class:`Block` (JAX stacks them on a leading
``[n_repeats]`` axis and scans; layer ``r · len(plan) + i`` here is the
``r``-th slice of JAX's plan position ``i``).  Weights keep JAX's
``[n_in, n_out]`` layout.

Entry points (eager; call the inference ones under
``torch.inference_mode()``):
  init_params(key, cfg, device)                 → Transformer
  forward(model, tokens|embeds)                 → (logits [B,S,V] fp32, aux)
  loss(model, batch)                            → scalar
  prefill(model, tokens|embeds, capacity)       → (logits [B,1,V], caches)
  decode_step(model, token, caches)             → (logits [B,1,V], caches)
  init_caches(cfg, batch, capacity, dtype, device)

``aux`` is the sum of the MoE layers' load-balance losses (0 without MoE).

The parameters are built with ``requires_grad=False``, so inference builds
no graph.  Training differentiates :func:`loss` through
``torch.func.functional_call`` with tensors that do require gradients in
place of the parameters (``fl/distributed.py`` hands it per-layer views of
a flat row); K2 and K3 then run through their custom ops, whose backward
recomputes the plain version (``kernels/ops.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig
from . import attention, mamba, moe, xlstm
from .costmode import cost_mode
from .layers import dense_init, init_swiglu, rms_norm, swiglu
from .pshard import replicate_over, settle, shard_dim, shard_last

MIXERS = ("attn", "mamba", "mlstm", "slstm")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def check_mixers(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` naming the first mixer of ``cfg`` that is none
    of :data:`MIXERS` (JAX raises ``ValueError`` for it too)."""
    for mixer, _ in cfg.layer_plan():
        if mixer not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")


class SwiGLU(nn.Module):
    def __init__(self, d: int, ff: int, dtype, device=None):
        super().__init__()
        self.w1 = _param((d, ff), dtype, device)
        self.w3 = _param((d, ff), dtype, device)
        self.w2 = _param((ff, d), dtype, device)

    def forward(self, x):
        return swiglu(x, self.w1, self.w3, self.w2)


_MIXER_MODULES = {"attn": attention.Attention, "mamba": mamba.Mamba,
                  "mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}
_MIXER_INIT = {"attn": attention.init_attn, "mamba": mamba.init_mamba,
               "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}
#: (forward and prefill, decode) of the mixers that carry a recurrent state
_RECURRENT = {"mamba": (mamba.mamba_forward, mamba.mamba_decode),
              "mlstm": (xlstm.mlstm_forward, xlstm.mlstm_decode),
              "slstm": (xlstm.slstm_forward, xlstm.slstm_decode)}
_CACHE_INIT = {"mamba": mamba.init_mamba_cache,
               "mlstm": xlstm.init_mlstm_cache,
               "slstm": xlstm.init_slstm_cache}


class Block(nn.Module):
    """One layer: ``x + mixer(rms_norm(x))``, then ``+ ffn(rms_norm(x))``
    when the layer has an FFN (JAX's ``_apply_layer``).  On DTensors, the
    residual is replicated over "model" as the layer starts (a sequence
    split there by the hint at super-block boundaries is gathered), and
    the row-parallel projections' pending sums are reduced before each
    residual add: Megatron's layout.  GSPMD may keep the residual split
    and reduce-scatter instead; DTensor cannot take the gradient of a
    projection whose tokens are split along the flattened sequence."""

    def __init__(self, cfg: ArchConfig, mixer: str, ffn: str, dtype,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.mixer_kind, self.ffn_kind = mixer, ffn
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.mixer = _MIXER_MODULES[mixer](cfg, dtype, device)
        if ffn != "none":
            self.ln2 = _param((cfg.d_model,), dtype, device)
        if ffn == "dense":
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)
        elif ffn == "moe":
            self.ffn = moe.MoE(cfg, dtype, device)

    def _mix(self, h, positions, mode, cache, capacity):
        cfg, p = self.cfg, self.mixer
        if self.mixer_kind == "attn":
            if mode == "train":
                return attention.attn_forward(p, cfg, h, positions), cache
            if mode == "prefill":
                return attention.attn_prefill(p, cfg, h, positions,
                                              capacity)
            return attention.attn_decode(p, cfg, h, cache)
        forward, decode = _RECURRENT[self.mixer_kind]
        if mode == "train":
            return forward(p, cfg, h), cache
        if mode == "prefill":
            return forward(p, cfg, h, return_cache=True)
        return decode(p, cfg, h, cache)

    def forward(self, x, positions, mode: str = "train", cache=None,
                capacity: int = 0):
        """Returns ``(x, new_cache, aux)``; ``aux`` is None unless the
        layer's FFN is MoE."""
        cfg = self.cfg
        x = replicate_over(x)       # a sequence-sharded carry is read whole
        y, new_cache = self._mix(rms_norm(x, self.ln1, cfg.norm_eps),
                                 positions, mode, cache, capacity)
        x = x + settle(y)
        aux = None
        if self.ffn_kind == "dense":
            x = x + settle(self.ffn(rms_norm(x, self.ln2, cfg.norm_eps)))
        elif self.ffn_kind == "moe":
            y, aux = moe.moe_forward(self.ffn, cfg,
                                     rms_norm(x, self.ln2, cfg.norm_eps))
            x = x + settle(y)
        return x, new_cache, aux


class Transformer(nn.Module):
    """``embed [V, d]``, ``layers``, ``final_norm [d]`` and, unless the
    embeddings are tied, ``unembed [d, V]``.  Allocated uninitialised:
    :func:`init_params` or ``convert.transformer_from_jax`` fills it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_mixers(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dtype = _dtype(cfg)
        plan = cfg.layer_plan()
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, mixer, ffn, dtype, device)
            for _ in range(cfg.n_repeats) for mixer, ffn in plan)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab), dtype, device)

    def forward(self, tokens=None, embeds=None):
        return forward(self, tokens, embeds)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(block: Block, key, cfg: ArchConfig, dtype, device):
    kmix, kffn = jr.split(key)
    block.ln1.fill_(1.0)
    _MIXER_INIT[block.mixer_kind](block.mixer, kmix)
    if block.ffn_kind != "none":
        block.ln2.fill_(1.0)
    if block.ffn_kind == "dense":
        for name, w in init_swiglu(kffn, cfg.d_model, cfg.d_ff, dtype,
                                   device).items():
            getattr(block.ffn, name).copy_(w)
    elif block.ffn_kind == "moe":
        moe.init_moe(block.ffn, kffn)


@torch.no_grad()
def init_params(key, cfg: ArchConfig, device=None) -> Transformer:
    """JAX's ``init_params`` through the port's threefry: one seed gives
    JAX's weights (normals within a few ulps, then the same cast to
    ``cfg.dtype``).  Each leaf is drawn, cast and written in turn, so the
    float32 and int64 temporaries of one leaf are freed before the next."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    model = Transformer(cfg, device)
    keys = jr.split(key, len(model.layers) + 3)
    for i, block in enumerate(model.layers):
        _init_layer(block, keys[i], cfg, dtype, device)
    model.embed.copy_(jr.normal(keys[-1], (cfg.vocab, cfg.d_model),
                                device=device) * 0.02)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        model.unembed.copy_(dense_init(keys[-2], cfg.d_model, cfg.vocab,
                                       dtype, device))
    return model


def _layer_cache(cfg: ArchConfig, mixer: str, batch: int, capacity: int,
                 dtype, device):
    if mixer == "attn":
        cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        return attention.init_cache(cfg, batch, cap, dtype, device)
    return _CACHE_INIT[mixer](cfg, batch, dtype, device)


def init_caches(cfg: ArchConfig, batch: int, capacity: int, dtype=None,
                device=None) -> list:
    """One empty cache per layer, of its mixer's kind: an
    :class:`attention.KVCache` (capped at the sliding window when there is
    one), a :class:`mamba.MambaCache`, an :class:`xlstm.MLSTMCache` or an
    :class:`xlstm.SLSTMCache`."""
    check_mixers(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    return [_layer_cache(cfg, mixer, batch, capacity, dtype, device)
            for _ in range(cfg.n_repeats) for mixer, _ in cfg.layer_plan()]


# ---------------------------------------------------------------------------
# model-level API
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(model.embed.dtype)
    # a row gather (the same values as indexing), which DTensor shards
    # vocab-parallel over a vocab-split table
    return settle(torch.nn.functional.embedding(tokens.long(), model.embed))


def _logits(model: Transformer, x):
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    if model.cfg.tie_embeddings:
        return (x @ model.embed.T).float()     # a transposed view, no copy
    return (x @ model.unembed).float()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def forward_hidden(model: Transformer, tokens=None, embeds=None):
    """Full-sequence causal forward → (hidden [B,S,d], aux)."""
    x = _embed(model, tokens, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    aux = x.new_zeros((), dtype=torch.float32)      # a DTensor on DTensors
    sb = len(model.cfg.mixer_pattern)
    for i, block in enumerate(model.layers):
        if i % sb == 0 and not cost_mode():
            # sequence parallelism at super-block boundaries, as JAX's scan
            # body gives it (its unrolled cost-mode branch gives none)
            x = shard_dim(x, -2, "model")
        x, _, a = block(x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(model: Transformer, tokens=None, embeds=None):
    """Full-sequence causal forward → (logits [B,S,V] fp32, aux)."""
    x, aux = forward_hidden(model, tokens, embeds)
    return _logits(model, x), aux


def loss(model: Transformer, batch: dict) -> torch.Tensor:
    """Next-token (or labeled) cross-entropy plus the MoE aux loss, a
    float32 scalar.

    batch: ``{"tokens": [B,S]}`` or ``{"embeds": [B,S,d], "labels":
    [B,S]}``.  As in JAX, the next-token shift happens on the hidden states
    before the unembedding, and the loss is ``logsumexp(logits) −
    logits[target]``: JAX picks the target with a one-hot contraction,
    whose one nonzero term gives the gather's value.
    """
    if "embeds" in batch:
        x, aux = forward_hidden(model, embeds=batch["embeds"])
        targets = batch["labels"]
    else:
        tokens = batch["tokens"]
        x, aux = forward_hidden(model, tokens=tokens)
        x = x[:, :-1]
        targets = tokens[:, 1:]
    logits = shard_last(_logits(model, x))              # [B,S',V] float32
    lse = torch.logsumexp(logits, dim=-1)
    tgt = settle(torch.gather(logits, -1, targets.long()[..., None]))[..., 0]
    ce = torch.mean(lse - tgt)
    moe_cfg = model.cfg.moe
    return ce + (moe_cfg.aux_loss_weight if moe_cfg is not None else 0.0) \
        * aux


def prefill(model: Transformer, tokens=None, embeds=None,
            capacity: int | None = None):
    """Process a prompt, returning (last-position logits, caches)."""
    x = _embed(model, tokens, embeds)
    B, S, _ = x.shape
    capacity = capacity or S
    positions = _positions(B, S, x.device)
    caches = []
    for block in model.layers:
        x, cache, _ = block(x, positions, "prefill", capacity=capacity)
        caches.append(cache)
    return _logits(model, x[:, -1:]), caches


def decode_step(model: Transformer, token, caches):
    """One-token decode.  token: [B, 1] ids → (logits [B,1,V], caches)."""
    x = _embed(model, tokens=token)
    new_caches = []
    for block, cache in zip(model.layers, caches):
        x, cache, _ = block(x, None, "decode", cache)
        new_caches.append(cache)
    return _logits(model, x), new_caches
