"""Server-side aggregation defenses (counterpart of the ``GuardConfig`` of
``repro.fl.faults``).  The array code that applies them is
:func:`repro_torch.fl.state.guard_weights`.

The fault processes of the JAX module (availability, crash, lossy uplink,
corruption), ``FaultConfig`` and ``run_fault_matrix`` are not ported yet:
they come with the rest of the robustness layer (``ROADMAP.md``, Queue 1
item 4).  Until then ``SimConfig.faults`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
