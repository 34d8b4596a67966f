"""Fault-injection processes and defensive-aggregation configuration
(counterpart of ``repro.fl.faults``).

The paper's premise is that clients are unreliable; these processes act on
the realized decision mask of every round, after the policy, never inside
it:

* **Markov on–off availability** — a two-state chain per client
  (``FaultState.avail``); a client that is down never starts its upload.
  Its failure rate is modulated by a sinusoid of the round with a
  per-client phase (``diurnal_amp``).
* **Mid-round crash** — a selected, available client dies before its
  upload: nothing lands, no uplink energy.
* **Lossy uplink with retry and backoff** — each attempt is lost with
  ``p_loss``; up to ``max_retries`` more attempts, attempt i costing
  ``backoff^i`` times the eq.-5 energy.  A lost upload still pays and
  leaves ``last_tx`` untouched, so its staleness grows.
* **Update corruption** — a delivered update is poisoned with
  ``p_corrupt``: NaN, Inf, or ``corrupt_scale`` × the honest update.

Every draw comes from ``fold_in(fold_in(base_key, t), 0x5AFE + i)``
(:func:`fault_key`), disjoint from the participation draw
``fold_in(base_key, t)``, so faults never perturb participation, and all
boolean and integer outcomes are bit for bit those of the JAX package.
The one float32 step that is not IEEE-exact everywhere, the diurnal
``sin``, is evaluated in float64 and rounded once (see
:func:`markov_availability`).

PyTorch is eager, so :func:`run_fault_matrix` runs its severity lanes one
after another through the single-run engine, with each lane's scaled
:class:`FaultParams`; JAX's ``vmap`` computes the same lanes.

Server-side defenses are configured here too (:class:`GuardConfig`); the
array code is :func:`repro_torch.fl.state.guard_weights`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as jr
from .. import resolve_device

#: fold_in salt of the per-round fault streams: disjoint from the
#: participation draw (fold_in(base_key, t) itself) and the data streams
_FAULT_SALT = 0x5AFE


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-process configuration.  All probabilities are per round; every
    field defaults to the clean world, so a config with one field set
    isolates one process."""

    # Markov on–off availability
    p_fail: float = 0.0        # P(up → down) per round
    p_recover: float = 1.0     # P(down → up) per round
    # p_fail·(1 + amp·sin(2πt/period + 2πk/K)); amp = 0 disables
    diurnal_amp: float = 0.0
    diurnal_period: int = 24
    # mid-round crash (selected, available, dies before the upload)
    p_crash: float = 0.0
    # uplink loss with bounded retry and backoff
    p_loss: float = 0.0        # per-attempt loss probability
    max_retries: int = 0       # extra attempts after the first
    backoff: float = 1.0       # attempt i costs backoff^i × the base energy
    # update corruption
    p_corrupt: float = 0.0
    corrupt_mode: str = "nan"  # "nan" | "inf" | "scale"
    corrupt_scale: float = 100.0

    @classmethod
    def from_trace(cls, avail, attempts=None, delivered=None,
                   max_retries: int = 0, **overrides) -> "FaultConfig":
        """Fit the Markov and loss rates from a trace
        (:meth:`FaultParams.from_trace`) and return a config that replays
        the fitted failure world; ``max_retries`` and any other field ride
        through ``overrides``."""
        fp = FaultParams.from_trace(avail, attempts=attempts,
                                    delivered=delivered, device="cpu")
        return cls(p_fail=float(fp.p_fail), p_recover=float(fp.p_recover),
                   p_loss=float(fp.p_loss), max_retries=max_retries,
                   **overrides)

    def params(self, device=None) -> "FaultParams":
        """The probabilistic fields as float32 0-dim tensors on ``device``
        (``None`` means the card)."""
        device = resolve_device(device)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return FaultParams(
            p_fail=f32(self.p_fail), p_recover=f32(self.p_recover),
            diurnal_amp=f32(self.diurnal_amp), p_crash=f32(self.p_crash),
            p_loss=f32(self.p_loss), backoff=f32(self.backoff),
            p_corrupt=f32(self.p_corrupt),
            corrupt_scale=f32(self.corrupt_scale))


class FaultParams(NamedTuple):
    """The probabilistic :class:`FaultConfig` fields as float32 0-dim
    tensors: what a severity sweep scales (``max_retries``,
    ``corrupt_mode`` and ``diurnal_period`` stay on the config)."""

    p_fail: torch.Tensor
    p_recover: torch.Tensor
    diurnal_amp: torch.Tensor
    p_crash: torch.Tensor
    p_loss: torch.Tensor
    backoff: torch.Tensor
    p_corrupt: torch.Tensor
    corrupt_scale: torch.Tensor

    @classmethod
    def from_trace(cls, avail, attempts=None, delivered=None,
                   device=None) -> "FaultParams":
        """Fit the probabilistic fields from an observed trace (MLE), as
        tensors on ``device`` (``None`` means the card).

        ``avail [T, K]`` is an availability history: ``p_fail = #(up→down)
        / #(up)`` and ``p_recover = #(down→up) / #(down)`` over consecutive
        rounds, the clean defaults 0 and 1 where no up (down) dwell was
        seen.  ``attempts`` and ``delivered`` (``[T, K]``, together) fit
        ``p_loss = (Σ attempts − #delivered) / Σ attempts``.  Everything
        else keeps its clean default.
        """
        a = np.asarray(avail).astype(bool)
        if a.ndim != 2:
            raise ValueError(f"avail must be [T, K], got shape {a.shape}")
        prev, nxt = a[:-1], a[1:]
        n_up = int(prev.sum())
        n_down = int(prev.size - n_up)
        p_fail = float((prev & ~nxt).sum() / n_up) if n_up else 0.0
        p_recover = float((~prev & nxt).sum() / n_down) if n_down else 1.0
        p_loss = 0.0
        if (attempts is None) != (delivered is None):
            raise ValueError("attempts and delivered must be given together")
        if attempts is not None:
            att = np.asarray(attempts, np.float64)
            dlv = np.asarray(delivered).astype(bool)
            if att.shape != dlv.shape:
                raise ValueError("attempts and delivered shapes differ: "
                                 f"{att.shape} vs {dlv.shape}")
            total = float(att.sum())
            if total > 0:
                p_loss = float(np.clip((total - dlv.sum()) / total, 0.0, 1.0))
        return FaultConfig(p_fail=p_fail, p_recover=p_recover,
                           p_loss=p_loss).params(device)


def scale_params(fp: FaultParams, rate) -> FaultParams:
    """Scale every failure probability by ``rate``, clipped to [0, 1]: the
    severity axis of a degradation sweep.  Recovery, backoff and the
    corruption magnitude stay; ``rate`` 0 is the clean world."""
    r = torch.as_tensor(rate, dtype=torch.float32, device=fp.p_fail.device)

    def clip(p):
        return torch.clamp(p * r, 0.0, 1.0)

    return fp._replace(p_fail=clip(fp.p_fail), p_crash=clip(fp.p_crash),
                       p_loss=clip(fp.p_loss), p_corrupt=clip(fp.p_corrupt))


class FaultState(NamedTuple):
    """Per-client fault state carried through the rounds."""

    avail: torch.Tensor   # [K] bool, the on–off chain (True = up)


class FaultOutcome(NamedTuple):
    """One round's fault realization, all ``[K]``."""

    delivered: torch.Tensor   # f32: the update landed at the server
    corrupt: torch.Tensor     # bool: delivered but poisoned
    attempts: torch.Tensor    # f32: uplink attempts made (0 = never started)
    avail: torch.Tensor       # bool: availability after this round's step
    e_round: torch.Tensor     # f32: energy including the retries


def init_fault_state(num_clients: int, device=None) -> FaultState:
    """Everyone starts available."""
    return FaultState(avail=torch.ones(num_clients, dtype=torch.bool,
                                       device=resolve_device(device)))


def fault_key(base_key: torch.Tensor, t, i: int) -> torch.Tensor:
    """Stream ``i`` of round ``t``: ``fold_in(fold_in(base_key, t),
    0x5AFE + i)``."""
    return jr.fold_in(jr.fold_in(base_key, t), _FAULT_SALT + i)


# ---------------------------------------------------------------------------
# the processes: (t, key, state) -> (outcome, state)
# ---------------------------------------------------------------------------

#: 2π as JAX's weak-typed Python float meets a float32 operand: rounded once
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def markov_availability(t, key, avail, fp: FaultParams, cfg: FaultConfig):
    """One step of the per-client on–off chain with diurnal modulation;
    returns ``(avail', avail')``.

    The failure rate is ``clip(p_fail·(1 + amp·sin(2π·t/period + φ_k)), 0,
    1)`` with ``φ_k = 2πk/K``, every step in JAX's float32 order.  The
    ``sin`` is taken in float64 and rounded to float32: XLA's, torch's CPU
    and CUDA's float32 ``sin`` each differ in the last place on a few
    percent of arguments, the rounded float64 one from XLA's on ~1 %.  A
    decision flips only when a uniform draw lies within that ulp.
    """
    K = avail.shape[0]
    dev = avail.device
    two_pi = torch.tensor(_TWO_PI_F32, dtype=torch.float32, device=dev)
    phase = two_pi * torch.arange(K, dtype=torch.float32, device=dev) / K
    tt = torch.as_tensor(t, device=dev).to(torch.float32)
    arg = two_pi * tt / cfg.diurnal_period + phase
    sin = torch.sin(arg.to(torch.float64)).to(torch.float32)
    mod = 1.0 + fp.diurnal_amp * sin
    p_fail_t = torch.clamp(fp.p_fail * mod, 0.0, 1.0)
    u = jr.uniform(key, (K,), device=dev)
    new_avail = torch.where(avail, u >= p_fail_t, u < fp.p_recover)
    return new_avail, new_avail


def crash_process(t, key, mask, fp: FaultParams):
    """Mid-round crash of a selected client before its upload; returns
    ``(crashed [K] bool, None)``."""
    del t
    u = jr.uniform(key, tuple(mask.shape), device=mask.device)
    return (mask > 0) & (u < fp.p_crash), None


def uplink_process(t, key, mask, fp: FaultParams, cfg: FaultConfig):
    """Lossy uplink with bounded retry and backoff.

    Attempt i ∈ {0..max_retries} is lost with ``p_loss``; the client stops
    at its first success.  Returns ``(landed [K] bool, attempts [K] f32,
    energy_mult [K] f32, None)`` with ``energy_mult = Σ_{i<attempts}
    backoff^i``: retries are paid whether or not the update lands.
    """
    del t
    K = mask.shape[0]
    A = cfg.max_retries + 1
    u = jr.uniform(key, (A, K), device=mask.device)
    ok = u >= fp.p_loss                                 # [A, K]
    # the first success (torch.argmax returns the first maximum); A if none
    first = torch.argmax(ok.to(torch.int32), dim=0)
    any_ok = torch.any(ok, dim=0)
    attempts = torch.where(any_ok, first + 1, A).to(torch.float32)
    i = torch.arange(A, dtype=torch.float32, device=mask.device)[:, None]
    cost = torch.where(i < attempts[None, :], fp.backoff ** i, 0.0)
    return any_ok, attempts, torch.sum(cost, dim=0), None


def corruption_process(t, key, delivered, fp: FaultParams):
    """Corruption draw over the delivered updates; returns ``(corrupt [K]
    bool, None)`` (the transform is :func:`corrupt_deltas`)."""
    del t
    u = jr.uniform(key, tuple(delivered.shape), device=delivered.device)
    return (delivered > 0) & (u < fp.p_corrupt), None


def corrupt_deltas(deltas: torch.Tensor, corrupt: torch.Tensor,
                   fp: FaultParams, cfg: FaultConfig) -> torch.Tensor:
    """Poison the flagged rows of the flat ``[R, W]`` deltas.

    ``"nan"`` and ``"inf"`` fill the whole row, the layout's pad columns
    included; ``"scale"`` multiplies it by ``corrupt_scale`` (finite, so it
    passes a finiteness quarantine and meets the norm clip), leaving the
    zero pad columns zero."""
    mode = cfg.corrupt_mode
    if mode == "scale":
        bad = deltas * fp.corrupt_scale
    elif mode in ("nan", "inf"):
        bad = torch.full_like(deltas, math.nan if mode == "nan" else math.inf)
    else:
        raise ValueError(f"unknown corrupt_mode {mode!r} "
                         "(expected nan|inf|scale)")
    return torch.where(corrupt.reshape(-1, 1), bad, deltas)


# ---------------------------------------------------------------------------
# the composed per-round pipeline (what the engines call)
# ---------------------------------------------------------------------------


def apply_faults(t, base_key, mask, e_round, fstate: FaultState,
                 fp: FaultParams, cfg: FaultConfig):
    """Every process on one round's decision (``mask``, ``e_round`` from
    ``apply_round_decision``): availability (down clients never start),
    crash (no uplink energy), the lossy uplink (retries multiply the
    energy; a total loss delivers nothing but pays), corruption of the
    delivered.  Returns ``(FaultOutcome, FaultState)``."""
    avail, _ = markov_availability(t, fault_key(base_key, t, 0),
                                   fstate.avail, fp, cfg)
    started = mask * avail.to(mask.dtype)
    crashed, _ = crash_process(t, fault_key(base_key, t, 1), started, fp)
    uploading = started * (~crashed).to(mask.dtype)
    landed, attempts, e_mult, _ = uplink_process(
        t, fault_key(base_key, t, 2), uploading, fp, cfg)
    delivered = uploading * landed.to(mask.dtype)
    # only clients that reached the uplink pay, scaled by their retries
    e_round = e_round * uploading * e_mult
    attempts = attempts * uploading
    corrupt, _ = corruption_process(t, fault_key(base_key, t, 3),
                                    delivered, fp)
    return (FaultOutcome(delivered=delivered, corrupt=corrupt,
                         attempts=attempts, avail=avail, e_round=e_round),
            FaultState(avail=avail))


# ---------------------------------------------------------------------------
# defensive aggregation configuration (array code: repro_torch.fl.state)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Server-side aggregation defenses — all mask-based, so the disabled
    configuration is the unguarded path.

    * ``quarantine`` — reject updates containing NaN/Inf (the whole client
      row); the surviving set keeps the paper's 1/K averaging.
    * ``clip_norm`` — per-client L2 clip of the pseudo-gradient: δ is scaled
      by ``min(1, clip_norm/‖δ‖)``.
    * ``staleness_power`` — polynomial down-weighting ``(1 + Δτ)^{-power}``
      of stale updates (Δτ = rounds since the client's last transmission).
    * ``staleness_cap`` — updates staler than the cap get weight 0.
    """

    quarantine: bool = True
    clip_norm: Optional[float] = None
    staleness_power: float = 0.0
    staleness_cap: Optional[int] = None

    @property
    def active(self) -> bool:
        return (self.quarantine or self.clip_norm is not None
                or self.staleness_power != 0.0
                or self.staleness_cap is not None)


# ---------------------------------------------------------------------------
# the degradation sweep
# ---------------------------------------------------------------------------


class FaultMatrixResult(NamedTuple):
    """:func:`run_fault_matrix`'s output: leading axis the severity rates,
    one entry per guard setting (``"unguarded"``, ``"guarded"``)."""

    rates: np.ndarray            # [R] severity multipliers
    acc: dict                    # {...: [R, n_evals]}
    loss: dict                   # same shape
    eval_rounds: np.ndarray      # [n_evals]
    energy: dict                 # {...: [R, K]} cumulative Joules
    delivered: dict              # {...: [R, T, K]} realized deliveries
    finite_final: dict           # {...: [R] bool} final model all finite
    # {...: MetricsState with [R]-leading fields} when cfg.metrics enables
    # taps; None otherwise
    metrics: Any = None


def run_fault_matrix(init_params, loss_fn, acc_fn, client_data, test_ds,
                     policy, h_all, cell, cfg, rates: Sequence[float],
                     guard: Optional[GuardConfig] = None,
                     device=None) -> FaultMatrixResult:
    """Accuracy and energy against fault severity, guarded and unguarded.

    ``cfg.faults`` must be set; lane r runs the simulation with every
    failure probability scaled by ``rates[r]`` (:func:`scale_params`).  The
    guarded setting uses ``guard`` (default: quarantine, a norm clip of 10
    and staleness power 0.5), the unguarded one ``guards=None``.  Each lane
    is one run of the dense engine (``device=None`` means the card); a
    state-free policy is solved once for every lane, since the lanes share
    ``h_all``.  ``finite_final`` reads the model's own parameters, not the
    flat row's pad columns.
    """
    from ..obs.taps import stack_metrics
    from ..obs.telemetry import emit_run_manifest
    from .engine import _dense_runner, matrix_data, solve_once

    if cfg.faults is None:
        raise ValueError("run_fault_matrix needs SimConfig(faults=...)")
    guard = guard or GuardConfig(quarantine=True, clip_norm=10.0,
                                 staleness_power=0.5)
    device = resolve_device(device)
    K = int(h_all.shape[0])
    base_fp = cfg.faults.params(device)
    rates_arr = np.asarray(list(rates), np.float32)
    fps = [scale_params(base_fp, float(r)) for r in rates_arr]
    h_all = torch.as_tensor(h_all, dtype=torch.float32).to(device)
    policy_fn = solve_once(policy, h_all)
    data, path = matrix_data(client_data, cfg, device)
    emit_run_manifest("run_fault_matrix", cfg,
                      extra={"rates": len(fps), "num_clients": K})
    out_acc, out_loss, out_energy, out_del, out_fin = {}, {}, {}, {}, {}
    out_ms: dict = {}
    eval_rounds = None
    for name, guards in (("unguarded", None), ("guarded", guard)):
        runner = _dense_runner(
            loss_fn, acc_fn, data, test_ds, policy_fn, cell,
            dataclasses.replace(cfg, guards=guards), device=device,
            data_path=path)
        lanes = [runner(init_params, h_all, fault_params=fp) for fp in fps]
        eval_rounds = lanes[0].eval_rounds
        out_acc[name] = np.stack([r.test_acc for r in lanes])
        out_loss[name] = np.stack([r.test_loss for r in lanes])
        out_energy[name] = np.stack([r.energy_per_client for r in lanes])
        out_del[name] = np.stack([r.delivered for r in lanes])
        ms = stack_metrics([r.metrics for r in lanes], (len(lanes),))
        if ms is not None:
            out_ms[name] = ms
        out_fin[name] = np.asarray([all(
            bool(torch.isfinite(p).all())
            for layer in r.state.layout.unflatten(r.state.global_params)
            for p in layer.values()) for r in lanes])
    return FaultMatrixResult(rates=rates_arr, acc=out_acc, loss=out_loss,
                             eval_rounds=eval_rounds, energy=out_energy,
                             delivered=out_del, finite_final=out_fin,
                             metrics=out_ms or None)
