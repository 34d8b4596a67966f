"""Paper math: channel model, Lambert W, the online (P1') solve, policies."""
from . import algorithm1, channel, online, selection
from .algorithm1 import ProblemSpec
from .channel import CellConfig
from .lambertw import lambertw
from .online import OnlineResult, solve_online

__all__ = ["algorithm1", "channel", "online", "selection", "ProblemSpec",
           "CellConfig", "lambertw", "OnlineResult", "solve_online"]
