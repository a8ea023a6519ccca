from repro_torch.core.anderson import (  # noqa: F401
    AA_IMPLS,
    AAConfig,
    AAStats,
    multisecant_update,
    resolve_aa_impl,
    trajectory_to_sy,
)
from repro_torch.core.algorithms import (  # noqa: F401
    ALGORITHMS,
    LOCAL_IMPLS,
    AlgoHParams,
    RoundMetrics,
    ServerState,
    comm_bytes_per_round,
    init_state,
    make_round_fn,
    resolve_local_impl,
)
from repro_torch.core.problem import (  # noqa: F401
    ClientBatch,
    FLProblem,
    LinearDesign,
    StackedClients,
    stack_client_arrays,
)
from repro_torch.core.server import History, run_federated, solve_reference  # noqa: F401
