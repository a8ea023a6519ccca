"""Robustness layer (counterpart of repro/robust): fault injection
(faults.py), the deadline-gated buffered aggregation (async_agg.py), storage
faults for the checkpoint save path (fs_faults.py); the clip_rtol defense
lives in core/anderson.py."""
from repro_torch.robust.async_agg import (  # noqa: F401
    ASYNC_AGE_KEY,
    ASYNC_BUF_KEY,
    AsyncConfig,
    AsyncRealization,
    CaptureReduce,
    advance_buffer,
    async_round_stats,
    discounted_weights,
    fold_buffered,
    guard_history_rows,
    init_async_comm,
    plan_async,
)
from repro_torch.robust.faults import (  # noqa: F401
    BYZ_MODES,
    FAULT_ANCHOR_KEY,
    LATENCY_DISTS,
    FaultPlan,
    FaultRealization,
    FaultyReduce,
    advance_anchor,
    drop_weights,
    fault_draws,
    freeze_dropped,
    init_fault_comm,
    poison_last_column,
    realize,
)
from repro_torch.robust.fs_faults import (  # noqa: F401
    KILL_EXIT_CODE,
    FaultyFs,
    FSFaultPlan,
    SimulatedKill,
)
