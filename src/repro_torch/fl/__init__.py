"""FL runtime: the eager simulation engine on the device data store."""
from .engine import (SimConfig, SimResult, apply_round_decision,
                     check_ported, grant_forced_bandwidth, make_local_train,
                     make_runner)
from .simulator import run_simulation
from .state import (FLState, ParamLayout, broadcast_to_participants,
                    init_fl_state, masked_aggregate, pseudo_gradients)

__all__ = ["SimConfig", "SimResult", "apply_round_decision", "check_ported",
           "grant_forced_bandwidth", "make_local_train", "make_runner",
           "run_simulation", "FLState", "ParamLayout",
           "broadcast_to_participants", "init_fl_state", "masked_aggregate",
           "pseudo_gradients"]
