"""Checkpointing: npz-based tree save/restore (counterpart of
repro/checkpoint/checkpoint.py, the same files on disk).

Flattens the tree with '/'-joined key paths (the reference's names, the
same flattener as sharded_ckpt.py: a ServerState's ``.params``, ``.t``,
``.comm/grad/ef``, …); restores into an identical structure, each leaf on
the template leaf's device and in its dtype. A tensor on the card is read
back with a blocking copy: this is the ``sync_gather`` baseline's save
(checkpoint/policy.py), the stall the sharded async path removes.

Saves are ATOMIC: both the ``.npz`` and its ``.meta.json`` go through the
write-temp-then-rename helper (checkpoint/atomic.py), so an interrupted or
concurrent save never leaves a torn file under the final name — a reader
sees the previous complete checkpoint or the new one, nothing in between.
For the preemption-tolerant sharded directory format (per-shard saves,
manifest commit marker, crash recovery) see checkpoint/sharded_ckpt.py.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any

import numpy as np

from repro_torch.checkpoint.atomic import (LOCAL_FS, LocalFs,
                                           write_bytes_atomic)
from repro_torch.checkpoint.sharded_ckpt import (_host_array, _leaf_keys,
                                                 _rebuild, _shape, _to_like)

Pytree = Any


def _flatten(tree: Pytree) -> "dict[str, np.ndarray]":
    """Host copies of every leaf by key (bf16 stored as f32, an int as
    int32)."""
    return {key: _host_array(leaf) for key, leaf in _leaf_keys(tree)}


def save_checkpoint(path: str, params: Pytree, step: int = 0,
                    extra: dict | None = None, fs: LocalFs = LOCAL_FS) -> None:
    flat = _flatten(params)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    write_bytes_atomic(npz_path, buf.getvalue(), fs=fs)
    meta = {"step": step, "keys": sorted(flat), **(extra or {})}
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    write_bytes_atomic(meta_path, json.dumps(meta).encode(), fs=fs)


def restore_checkpoint(path: str, like: Pytree) -> Pytree:
    """Restore into the structure of ``like`` (shape/dtype/device
    template)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)

    def leaf(key, tmpl):
        arr = data[key]
        assert arr.shape == _shape(tmpl), (key, arr.shape, _shape(tmpl))
        return _to_like(np.array(arr, copy=True), tmpl)

    return _rebuild(like, leaf)


def latest_step(ckpt_dir: str) -> int | None:
    metas = [f for f in os.listdir(ckpt_dir) if f.endswith(".meta.json")]
    if not metas:
        return None
    steps = []
    for m in metas:
        with open(os.path.join(ckpt_dir, m)) as f:
            steps.append(json.load(f).get("step", 0))
    return max(steps)
