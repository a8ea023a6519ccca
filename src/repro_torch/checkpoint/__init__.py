"""Checkpointing (counterpart of repro/checkpoint): the atomic commit
protocol (atomic.py), the sharded directory format with newest-complete
discovery (sharded_ckpt.py), the legacy single-file npz (checkpoint.py), and
the async save manager the engine and the loop drive (policy.py). Storage
faults for its tests come from robust/fs_faults.py."""
from repro_torch.checkpoint.atomic import (  # noqa: F401
    LOCAL_FS, LocalFs, commit_dir, sha256_hex, with_retries,
    write_bytes_atomic,
)
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint.policy import (  # noqa: F401
    CheckpointManager, CheckpointPolicy,
)
from repro_torch.checkpoint.sharded_ckpt import (  # noqa: F401
    CheckpointConfigMismatch, ckpt_name, inventory_of, list_checkpoints,
    load_checkpoint, load_latest, prune_checkpoints, snapshot_shards,
    verify_checkpoint, write_checkpoint,
)
