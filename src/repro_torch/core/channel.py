"""Wireless channel model for the FL cell network (paper §II-B, Table II).

Counterpart of ``repro.core.channel``.  Rates are kept in *nats*
(``rate_nats = w·W·ln(1+SNR)``) and the model size ``S`` is converted from
bits to nats, so the paper's closed forms (eqs. 26, 31, 46) hold verbatim.
Everything is float32, with scalar constants rounded to float32 at each
operation exactly as JAX's weak types are.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random as jr
from .. import resolve_device

LN2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Wireless network parameters (paper Table II)."""

    num_clients: int = 10
    cell_radius_m: float = 1000.0
    bandwidth_hz: float = 5e6                  # W
    tx_power_w: float = 0.2                    # P_k (uniform in the paper)
    noise_dbm_per_hz: float = -174.0           # N_0
    model_size_bits: float = 6.37e6            # S (MNIST MLP in the paper)
    min_radius_m: float = 1.0                  # avoid log10(0) at the server

    @property
    def noise_w_per_hz(self) -> float:
        return 10.0 ** (self.noise_dbm_per_hz / 10.0) * 1e-3

    @property
    def model_size_nats(self) -> float:
        return self.model_size_bits * LN2


def path_loss_db(dist_m: torch.Tensor) -> torch.Tensor:
    """``128.1 + 37.6 log10(r_km)`` dB (3GPP TR 36.814, paper Table II)."""
    r_km = torch.clamp(dist_m, min=1.0) / 1000.0
    return 128.1 + 37.6 * torch.log10(r_km)


def path_gain(dist_m: torch.Tensor) -> torch.Tensor:
    """Linear channel power gain from the 3GPP path loss."""
    return torch.pow(10.0, -path_loss_db(dist_m) / 10.0)


def sample_positions(key: torch.Tensor, cfg: CellConfig,
                     r_min: float | None = None, r_max: float | None = None,
                     device=None) -> torch.Tensor:
    """Uniform positions in an annulus [r_min, r_max] of the cell (meters),
    uniform in area: ``r = sqrt(u·(r_max²−r_min²)+r_min²)``."""
    r_min = cfg.min_radius_m if r_min is None else r_min
    r_max = cfg.cell_radius_m if r_max is None else r_max
    u = jr.uniform(key, (cfg.num_clients,), device=device)
    return torch.sqrt(u * (r_max**2 - r_min**2) + r_min**2)


def sample_fading(key: torch.Tensor, shape: tuple[int, ...],
                  device=None) -> torch.Tensor:
    """Rayleigh block fading: exponential(1) power gain (``device=None``:
    the card)."""
    return jr.exponential(key, shape, device=resolve_device(device))


def channel_gains(key: torch.Tensor, dist_m: torch.Tensor,
                  num_rounds: int) -> torch.Tensor:
    """``h_{k,t}`` ``[num_rounds, K]``: path gain × i.i.d. Rayleigh fading
    (exponential(1) power gain) per round, on ``dist_m``'s device."""
    fading = sample_fading(key, (num_rounds, dist_m.shape[0]),
                           device=dist_m.device)
    return fading * path_gain(dist_m)[None, :]


def rate_nats(w: torch.Tensor, h: torch.Tensor, P: float, W: float,
              N0: float) -> torch.Tensor:
    """Achievable rate (eq. 4) in nats/s: ``w·W·ln(1 + P·h / (w·W·N0))``.
    Safe at w→0 (the rate goes to 0)."""
    w_safe = torch.clamp(w, min=1e-12)
    snr = P * h / (w_safe * W * N0)
    return w_safe * W * torch.log1p(snr)


def rate_bits(w: torch.Tensor, h: torch.Tensor, P: float, W: float,
              N0: float) -> torch.Tensor:
    """Achievable rate in bits/s (Shannon log2)."""
    return rate_nats(w, h, P, W, N0) / LN2


def tx_energy_j(p: torch.Tensor, w: torch.Tensor, h: torch.Tensor, P: float,
                W: float, N0: float, S_nats: float) -> torch.Tensor:
    """Expected per-client transmit energy (eq. 5 summand): ``p·P·S / R``.

    Returns per-client energies; sum for E_t.  Where ``p`` is 0 the energy
    is 0; where ``w`` is 0 and ``p > 0`` the rate is 0 and the energy
    huge (the rate is clamped at 1e-30)."""
    R = rate_nats(w, h, P, W, N0)
    e = p * P * S_nats / torch.clamp(R, min=1e-30)
    return torch.where(p <= 0.0, 0.0, e)
