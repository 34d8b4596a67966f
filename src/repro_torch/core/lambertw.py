"""Principal branch of the Lambert W function (counterpart of
``repro.core.lambertw``).

The bandwidth closed form (eq. 31) evaluates ``W0(-exp(-A))`` with ``A ≥ 1``,
i.e. arguments in ``[-1/e, 0)``.  W0 is computed on its full domain
``[-1/e, ∞)`` from a branch-aware initial guess and 12 Halley steps, in
float32 throughout, operation for operation as the JAX version.

The JAX source guards ``|denom| < 1e-300``; that literal rounds to 0 in
float32 in both frameworks, so the guard never fires and the Halley step
below divides by ``denom`` directly, which gives the same bits.  It is not
"fixed" into a real guard: the two versions stay step for step identical.
The bandwidth solve calls this some 10⁴ times on tensors of a few hundred
elements, so its cost is host overhead per operation.  So the Halley loop
stops early once its iterates repeat: every second step it compares w with
w two steps before, and if no element moved, the map (elementwise, the same
for every step) can only repeat that cycle of length 1 or 2, and the
remaining steps, an even number, would end on this w.  The result is the
one all 12 steps give, bit for bit.  The Halley loop's
constants are 0-dim float32 CPU tensors made once (an operation with a
Python scalar costs about twice as much on the host as one with a tensor,
and a CPU 0-dim tensor combines with a CUDA tensor as a scalar, without a
copy).
"""
from __future__ import annotations

import math

import torch

INV_E = 0.36787944117144233  # 1/e

#: arguments this far below −1/e snap to the branch point instead of going
#: NaN (float32 rounding of ``−exp(−A)`` with ``A ≥ 1`` can land a valid
#: argument a few ulp outside the domain).
BRANCH_TOL = 1e-6

_ONE, _TWO, _BRANCH_EPS = (torch.tensor(v, dtype=torch.float32)
                           for v in (1.0, 2.0, 1e-12))


def _initial_guess(x: torch.Tensor) -> torch.Tensor:
    # series about the branch point: W = -1 + p - p²/3 + 11p³/72
    p = torch.sqrt(torch.clamp(2.0 * (math.e * x + 1.0), min=0.0))
    p2 = p * p
    near_branch = -1.0 + p - p2 / 3.0 + 11.0 * (p2 * p) / 72.0
    # asymptotic for large x: L1 - L2 + L2/L1
    l1 = torch.log(torch.clamp(x, min=2.0))
    l2 = torch.log(l1)
    asym = l1 - l2 + l2 / l1
    # Padé-ish mid-range guess
    mid = x * (1.0 + 1.4586887 * x) / (1.0 + x * (2.4586887 + 0.43478693 * x))
    return torch.where(x < -0.2, near_branch, torch.where(x > 2.0, asym, mid))


def lambertw(x: torch.Tensor) -> torch.Tensor:
    """W0(x) for x ≥ -1/e, element-wise, in float32.  NaN outside the domain,
    except fp noise within ``BRANCH_TOL`` below -1/e, which clamps to the
    branch point (W = -1).

    The Halley loop writes into buffers it allocated once (``out=`` and
    in-place operations): each step is the same float32 arithmetic as the
    JAX version, at half the host cost of fresh tensors.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    x = torch.where((x < -INV_E) & (x >= -INV_E - BRANCH_TOL), -INV_E, x)
    w = _initial_guess(x)
    ew, f, wp1, denom, t = (torch.empty_like(w) for _ in range(5))
    at_branch = torch.empty_like(w, dtype=torch.bool)
    before = None     # w two steps back, kept after every second step
    for step in range(1, 13):
        torch.exp(w, out=ew)
        torch.mul(w, ew, out=f).sub_(x)                    # f = w·e^w − x
        torch.add(w, _ONE, out=wp1)
        # denom = e^w·(w+1) − (w+2)·f / (2·(w+1)), with 2·(w+1) == (w+1)+(w+1)
        torch.add(w, _TWO, out=t).mul_(f).div_(torch.add(wp1, wp1, out=denom))
        torch.mul(ew, wp1, out=denom).sub_(t)
        torch.div(f, denom, out=t)
        # guard the branch point where wp1 -> 0
        torch.lt(wp1.abs_(), _BRANCH_EPS, out=at_branch)
        w.sub_(t.masked_fill_(at_branch, 0.0))
        if step % 2 == 0 and step < 12:
            if before is not None and torch.equal(w, before):
                break     # a cycle of length 1 or 2: step 12 would be w
            before = w.clone()
    w = torch.where(x < -INV_E, torch.nan, w)
    # exact at the branch point
    return torch.where((x + INV_E).abs() <= 1e-12, -1.0, w)
