"""Paper math: channel model, Lambert W, Algorithm 1 (offline) and its
online (P1') variant, the fractional-programming residuals, the convergence
bounds, and the client-selection policies."""
from . import (algorithm1, channel, convergence, fractional, online,
               selection)
from .algorithm1 import Algorithm1Result, ProblemSpec, objective_p1
from .channel import CellConfig
from .lambertw import lambertw
from .online import OnlineResult, solve_online

__all__ = [
    "algorithm1", "channel", "convergence", "fractional", "online",
    "selection", "Algorithm1Result", "ProblemSpec", "objective_p1",
    "CellConfig", "lambertw", "OnlineResult", "solve_online",
]
