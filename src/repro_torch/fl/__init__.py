"""FL runtime: the eager simulation engine on the device data store, the
participant-centric sparse engine, and the aggregators (eq. 3, guarded,
participant-subset and scheme-weighted)."""
from . import sparse
from .engine import (SimConfig, SimResult, apply_round_decision,
                     check_ported, grant_forced_bandwidth, make_local_train,
                     make_runner, resolve_data_path)
from .faults import GuardConfig
from .sparse import make_sparse_runner, resolve_participation
from .simulator import run_simulation
from .state import (AggParams, AggregatorConfig, FLState, ParamLayout,
                    broadcast_to_participants, finite_rows, guard_weights,
                    guarded_aggregate, guarded_subset_aggregate,
                    init_fl_state, masked_aggregate, pseudo_gradients,
                    scheme_aggregate, scheme_subset_aggregate, scheme_weights,
                    staleness_scale, subset_aggregate, update_norms,
                    weighted_aggregate)

__all__ = ["SimConfig", "SimResult", "apply_round_decision", "check_ported",
           "grant_forced_bandwidth", "make_local_train", "make_runner",
           "run_simulation", "resolve_data_path", "FLState", "ParamLayout",
           # participant-centric sparse rounds
           "sparse", "make_sparse_runner", "resolve_participation",
           "broadcast_to_participants", "init_fl_state", "masked_aggregate",
           "pseudo_gradients", "subset_aggregate",
           # robustness layer: the server-side guards
           "GuardConfig", "finite_rows", "update_norms", "guard_weights",
           "guarded_aggregate", "guarded_subset_aggregate",
           # the scheme aggregators
           "AggParams", "AggregatorConfig", "scheme_aggregate",
           "scheme_subset_aggregate", "scheme_weights", "staleness_scale",
           "weighted_aggregate"]
