"""FL runtime: the eager simulation engine on the device, prestack and
stream data paths, its client axis placed over several cards, resumable checkpointed runs, the participant-centric
sparse engine, the legacy host round loop, the fault processes, the
aggregators (eq. 3, guarded, participant-subset and scheme-weighted) and
the seed, scenario, fault and scheme matrices, each with the metrics taps
of :mod:`repro_torch.obs.taps`."""
from . import sparse
from .engine import (MatrixResult, RoundTrace, SimConfig, SimResult,
                     apply_round_decision, build_chunk_sim, check_modes,
                     grant_forced_bandwidth, init_carry, make_local_train,
                     make_runner, resolve_data_path, run_scenario_matrix,
                     run_seed_matrix, stack_round_batches)
from .faults import (FaultConfig, FaultMatrixResult, FaultOutcome,
                     FaultParams, FaultState, GuardConfig, apply_faults,
                     corrupt_deltas, fault_key, init_fault_state,
                     run_fault_matrix, scale_params)
from .placement import ClientPlacement, PlacedStore
from .resume import (completed_segments, read_segment_manifest,
                     run_resumable, segment_bounds)
from .schemes import (SchemeMatrixResult, SchemeSpec, default_scheme_panel,
                      run_scheme_matrix, stack_stores)
from .simulator import make_round_fn, run_simulation, run_simulation_legacy
from .sparse import (ParticipationTrace, build_participation_program,
                     build_sparse_train_program, make_sparse_runner,
                     resolve_participation, train_trace_count)
from .state import (AggParams, AggregatorConfig, FLState, ParamLayout,
                    RowBlocks, broadcast_to_participants, finite_rows, guard_weights,
                    guarded_aggregate, guarded_subset_aggregate,
                    init_fl_state, masked_aggregate, pseudo_gradients,
                    scheme_aggregate, scheme_subset_aggregate, scheme_weights,
                    staleness_scale, subset_aggregate, update_norms,
                    weighted_aggregate)

__all__ = ["SimConfig", "SimResult", "apply_round_decision", "check_modes",
           "grant_forced_bandwidth", "make_local_train", "make_runner",
           "run_simulation", "run_simulation_legacy", "make_round_fn",
           "resolve_data_path", "FLState", "ParamLayout",
           "run_seed_matrix", "run_scenario_matrix", "MatrixResult",
           "RoundTrace", "build_chunk_sim", "init_carry",
           "stack_round_batches",
           # client-axis placement (JAX's shard_clients)
           "ClientPlacement", "PlacedStore", "RowBlocks",
           # resumable runs
           "run_resumable", "segment_bounds", "completed_segments",
           "read_segment_manifest",
           # participant-centric sparse rounds
           "sparse", "make_sparse_runner", "resolve_participation",
           "build_participation_program", "build_sparse_train_program",
           "ParticipationTrace", "train_trace_count",
           "broadcast_to_participants", "init_fl_state", "masked_aggregate",
           "pseudo_gradients", "subset_aggregate",
           # robustness layer: fault processes and server-side guards
           "FaultConfig", "FaultParams", "FaultState", "FaultOutcome",
           "GuardConfig", "FaultMatrixResult", "apply_faults",
           "corrupt_deltas", "fault_key", "init_fault_state", "scale_params",
           "run_fault_matrix", "finite_rows", "update_norms",
           "guard_weights", "guarded_aggregate", "guarded_subset_aggregate",
           # the scheme aggregators and the scheme matrix
           "AggParams", "AggregatorConfig", "SchemeMatrixResult",
           "SchemeSpec", "default_scheme_panel", "run_scheme_matrix",
           "stack_stores", "scheme_aggregate", "scheme_subset_aggregate",
           "scheme_weights", "staleness_scale", "weighted_aggregate"]
