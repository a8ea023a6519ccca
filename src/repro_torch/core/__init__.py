from repro_torch.core.anderson import (  # noqa: F401
    AA_IMPLS,
    AAConfig,
    AAStats,
    aa_mixing_step,
    lbfgs_two_loop,
    multisecant_update,
    resolve_aa_impl,
    trajectory_to_sy,
)
from repro_torch.core.algorithms import (  # noqa: F401
    ALGORITHMS,
    COMM_TABLE,
    LINE_SEARCH_ALGOS,
    LOCAL_IMPLS,
    NEWTON_ALGOS,
    TRAJECTORY_ALGOS,
    AlgoHParams,
    CommCost,
    RoundMetrics,
    ServerState,
    UPLINK_SCHEMAS,
    CrossClientReduce,
    comm_bytes_per_round,
    comm_floats_per_round,
    fused_local_eligible,
    init_comm_state,
    init_state,
    make_round_fn,
    resolve_cohort_size,
    resolve_local_impl,
)
from repro_torch.core.client_store import (  # noqa: F401
    ClientStateStore,
    gather_rows,
    scatter_rows,
)
from repro_torch.comm.schema import UplinkSpec  # noqa: F401
from repro_torch.comm import CommChannel, make_channel  # noqa: F401
from repro_torch.core.sharded import make_sharded_round_fn  # noqa: F401
from repro_torch.core.problem import (  # noqa: F401
    ClientBatch,
    FLProblem,
    LinearDesign,
    StackedClients,
    sample_minibatch,
    sample_minibatch_indices,
    stack_client_arrays,
)
from repro_torch.core.engine import (  # noqa: F401
    METRIC_FIELDS,
    RoundTrace,
    make_chunk_runner,
    run_rounds,
)
from repro_torch.core.server import History, run_federated, solve_reference  # noqa: F401
