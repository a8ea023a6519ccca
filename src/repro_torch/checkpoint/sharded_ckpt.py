"""Preemption-tolerant sharded checkpoint format (counterpart of
repro/checkpoint/sharded_ckpt.py, the same files on disk): per-process shard
files, a digest-carrying manifest, newest-complete discovery.

Layout of one committed checkpoint (all staged in a ``.tmp-*`` sibling and
renamed into place by checkpoint/atomic.commit_dir — the manifest is written
last, so a ``ckpt_<round>`` directory with a valid manifest IS the commit
marker)::

    <dir>/ckpt_00000042/
        shards_p0000.npz     one npz per writing process: every shard of
        ...                  every ServerState leaf that process holds,
        manifest.json        entries keyed "<leaf-key>::<shard#>"

Manifest (format version :data:`CKPT_FORMAT`)::

    round            global round the state is AFTER
    leaves           per-leaf: global shape, dtype, stored dtype, and the
                     shard list [{file, entry, box, sha256, bytes}] — box is
                     [(start, stop)] per dim in the global index space
    inventory        what rode along (comm tags incl. async buffers and
                     fault anchors / AA history / the round counter)
    config           run fingerprint (algo/runtime/channel/fault params/…);
                     ``expect_config`` on load REFUSES a mismatch instead of
                     letting a resumed run silently diverge

Leaf keys are the reference's: jax's tree paths joined by "/", so a
NamedTuple field is ``.name`` and a dict key is itself (``.params``,
``.t``, ``.hist_s``, ``.comm/grad/ef``, ``.comm/__async_age__``); a field
that is None is no leaf. The port's ``ServerState.t`` is a Python int: it is
stored as the reference stores its ``t``, a 0-d int32 leaf, and restores as
an int. Every draw of a port round is keyed by (seed, ``t``, fold) — the
uplink's uniforms, the cohort, the minibatches, the faults — so restoring
``t`` is what makes a resume bit-exact. The port has no PRNG key, so no
``rng`` leaf, and the inventory says ``"rng": false``.

The vmap runtime's one device holds every leaf whole, so each leaf is one
shard with the full box, in ``shards_p0000.npz``. Under the sharded runtime
(core/sharded.py, a ``ClientShard`` passed as ``shard=``) rank r writes
``shards_p{r:04d}.npz`` with its rows of every per-client leaf (box
``((k0, k1), (0, d), ...)`` of the global [K, ...] leaf), and rank 0 adds
the replicated ones (params, c, t) whole; every rank stages into one
directory that rank 0 names, and rank 0 writes the manifest of all the
ranks' entries and commits once every rank has staged
(``write_checkpoint(group=)``). A restore assembles each global leaf and a
rank takes its rows, so a checkpoint restores at any world size that
divides K. A checkpoint written by the reference restores into a port
template: leaves the template lacks (its ``.rng``, SCAFFOLD's
``.c``/``.c_k`` outside the SCAFFOLD family) are ignored, as the
reference's own restore ignores them.

Completeness is verified on load, never assumed: every referenced shard file
must exist, every entry's sha256 must match, and the shard boxes of every
leaf must tile its full global shape. :func:`load_latest` walks the
committed rounds newest-first and restores from the first checkpoint that
passes — torn manifests, bad digests, missing shards, stray garbage files
are all skipped (and reported), exactly the recovery a preempted run needs.

This module is host I/O and the snapshot's device→host copies; the async
dispatch and backpressure live in checkpoint/policy.py.
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.atomic import (LOCAL_FS, LocalFs, commit_dir,
                                           sha256_hex, write_bytes_atomic)

Pytree = Any

logger = logging.getLogger("repro_torch.checkpoint")

CKPT_FORMAT = 1
MANIFEST = "manifest.json"

_CKPT_RE = re.compile(r"^ckpt_(\d{8})$")

#: dtypes npz cannot hold, stored as float32 (the manifest keeps the true
#: dtype; restore casts back, exactly)
_WIDENED = (torch.bfloat16,)


class CheckpointConfigMismatch(RuntimeError):
    """The newest complete checkpoint was written by a run with a different
    config fingerprint — resuming would silently diverge, so refuse."""


def ckpt_name(round_idx: int) -> str:
    return f"ckpt_{round_idx:08d}"


# ---------------------------------------------------------------------------
# the tree: ServerState (a NamedTuple with dicts in ``comm``), dicts, lists
# ---------------------------------------------------------------------------
def _children(node) -> "list[tuple[str, Any]] | None":
    """(path entry, child) of a container node, in jax's order; None for a
    leaf. A NamedTuple field is ``.name``, a dict key itself (sorted), a
    list or tuple entry its index."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaf_keys(tree: Pytree) -> "list[tuple[str, Any]]":
    """(key, leaf) of every leaf, keys '/'-joined paths (the reference's
    naming, shared with the legacy npz format); None is no leaf."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for entry, child in kids:
            walk(child, path + [entry])

    walk(tree, [])
    return out


def _rebuild(tree: Pytree, fn: Callable[[str, Any], Any]) -> Pytree:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``; the same
    containers (a NamedTuple of its own type, a dict in its own key order),
    None kept."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        kids = _children(node)
        if kids is None:
            return fn("/".join(path), node)
        vals = [walk(child, path + [entry]) for entry, child in kids]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return walk(tree, [])


def _dtype_name(leaf) -> str:
    """The leaf's dtype by numpy's name ("float64", "int32", "bfloat16");
    a Python int is the reference's int32 round counter."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, int):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _host_array(leaf) -> np.ndarray:
    """A host numpy copy of a leaf (a blocking read of a card tensor), bf16
    widened to float32, a Python int as int32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _WIDENED:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf, copy=True)


def _shape(leaf) -> "tuple[int, ...]":
    return tuple(int(n) for n in getattr(leaf, "shape", ()))


def _to_like(full: np.ndarray, like):
    """A restored array as the template leaf's kind: a tensor on the
    template's device in its dtype, an int, or a numpy array in its dtype."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(full).to(device=like.device, dtype=like.dtype)
    if isinstance(like, (int, float)):
        return type(like)(full)
    return np.asarray(full, dtype=np.asarray(like).dtype)


# ---------------------------------------------------------------------------
# snapshot: the state's values on the host, safe from the next chunk
# ---------------------------------------------------------------------------
class Snapshot(dict):
    """``{leaf_key: {"shape", "dtype", "shards": [(box, np.ndarray)]}}``.

    ``ready`` is the CUDA event recorded after the device→host copies into
    pinned buffers (None when no leaf lies on the card): the host arrays
    hold the state's values only once it has completed, so a writer calls
    :meth:`wait` first (``write_checkpoint`` does)."""

    def __init__(self):
        super().__init__()
        self.ready: "torch.cuda.Event | None" = None

    def wait(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()


def _pinned(pool: "dict | None", key: str, like: torch.Tensor) -> torch.Tensor:
    """The pinned host buffer of ``key`` in ``pool`` (allocated once, reused
    while the leaf's shape and dtype stay the same)."""
    buf = pool.get(key) if pool is not None else None
    if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        if pool is not None:
            pool[key] = buf
    return buf


def snapshot_shards(state: Pytree, pinned: "dict | None" = None,
                    shard=None) -> Snapshot:
    """Host-side snapshot of every leaf as one shard with the full box; with
    ``shard`` (a core/sharded.py ClientShard), of this rank's boxes: its
    rows of each per-client leaf, and on rank 0 the replicated leaves.

    A leaf on the CPU is copied. A leaf on the card is copied into a pinned
    host buffer (from ``pinned``, a ``{key: tensor}`` pool reused across
    saves, or a new one) with ``non_blocking=True`` on the current stream,
    and a CUDA event is recorded after the copies (``Snapshot.ready``): no
    host wait here. Work enqueued on that stream later — the engine's next
    graph replay, which overwrites the runner's buffers the state lives in
    — runs after the copies. bf16 is stored as f32 (npz cannot hold it) and
    the manifest records the true dtype, so restore casts back.
    """
    snap = Snapshot()
    on_card = False
    for key, leaf in _leaf_keys(state):
        shape = _shape(leaf)
        boxes = [tuple((0, n) for n in shape)]
        if shard is not None:
            shape, boxes = shard.leaf_boxes(key, shape)
            if not boxes:
                continue
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            src = leaf.detach()
            if src.dtype in _WIDENED:
                src = src.to(torch.float32)
            host = _pinned(pinned, key, src)
            host.copy_(src, non_blocking=True)
            arr = host.numpy()
            on_card = True
        else:
            arr = _host_array(leaf)
        snap[key] = {"shape": shape, "dtype": _dtype_name(leaf),
                     "shards": [(boxes[0], arr)]}
    if on_card:
        snap.ready = torch.cuda.Event()
        snap.ready.record()
    return snap


def inventory_of(snapshot: "dict[str, dict]") -> dict:
    """What the checkpoint carries, by subsystem — the manifest field that
    lets `load` (and a human) confirm nothing was silently dropped."""
    # tree-path keys carry a leading "." for NamedTuple attrs (".hist_s",
    # ".comm/grad/ef") — normalize before classifying
    keys = sorted(k.lstrip(".") for k in snapshot)
    comm_tags = sorted({k.split("/")[1] for k in keys
                        if k.startswith("comm/")})
    return {
        "num_leaves": len(keys),
        "rng": any(k == "rng" or k.startswith("rng/") for k in keys),
        "round_counter": "t" in keys,
        "comm_tags": comm_tags,
        "aa_history": any(k.startswith("hist_s") for k in keys),
        "async_buffers": any("__async_buf__" in k for k in keys),
        "fault_anchors": any("__fault_anchor__" in k for k in keys),
    }


def _stage(tmp: str, fname: str, snapshot: "dict[str, dict]", fs: LocalFs,
           retries: int, backoff_s: float, sleep) -> "tuple[dict, int]":
    """Write this process's shard file into ``tmp``. Returns (its manifest
    leaf records, the file's bytes)."""
    entries: "dict[str, np.ndarray]" = {}
    leaves = {}
    for key, rec in snapshot.items():
        shard_meta = []
        for i, (box, arr) in enumerate(rec["shards"]):
            entry = f"{key}::{i}"
            entries[entry] = arr
            shard_meta.append({
                "file": fname,
                "entry": entry,
                "box": [[int(a), int(b)] for a, b in box],
                "sha256": sha256_hex(arr.tobytes()),
                "bytes": int(arr.nbytes),
            })
        leaves[key] = {
            "shape": list(rec["shape"]),
            "dtype": rec["dtype"],
            "stored_dtype": str(rec["shards"][0][1].dtype),
            "shards": shard_meta,
        }
    buf = io.BytesIO()
    # npz keys with '/' are legal (zip member names); savez handles them
    np.savez(buf, **entries)
    payload = buf.getvalue()
    write_bytes_atomic(os.path.join(tmp, fname), payload, fs=fs,
                       retries=retries, backoff_s=backoff_s, sleep=sleep)
    return leaves, len(payload)


def _commit(tmp: str, final: str, round_idx: int, leaves: dict,
            files: "list[str]", config: dict | None, fs: LocalFs,
            retries: int, backoff_s: float, sleep) -> int:
    """Write the manifest of ``leaves`` (every process's entries) into
    ``tmp`` and rename it to ``final``. Returns the manifest's bytes."""
    manifest = {
        "format": CKPT_FORMAT,
        "round": int(round_idx),
        "processes": len(files),
        "files": files,
        "leaves": leaves,
        "inventory": inventory_of(leaves),
        "config": config or {},
    }
    mbytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    # manifest LAST: its presence inside a committed dir is the marker
    write_bytes_atomic(os.path.join(tmp, MANIFEST), mbytes, fs=fs,
                       retries=retries, backoff_s=backoff_s, sleep=sleep)
    if fs.exists(final):
        # a prior run already committed this round (e.g. rerun into the
        # same directory without resume): the new save supersedes it.
        # os.replace cannot overwrite a non-empty directory, so drop the
        # stale one first — the only window without a ckpt for this
        # round is here, and the previous-newest checkpoint still covers
        # recovery.
        logger.warning("checkpoint %s already exists; overwriting", final)
        fs.rmtree(final)
    commit_dir(tmp, final, fs=fs, retries=retries, backoff_s=backoff_s,
               sleep=sleep)
    return len(mbytes)


def _drop_tmp(tmp: str, fs: LocalFs) -> None:
    try:
        fs.rmtree(tmp)
    except OSError:
        pass


def write_checkpoint(directory: str, snapshot: "dict[str, dict]",
                     round_idx: int, *, config: dict | None = None,
                     fs: LocalFs = LOCAL_FS, process_index: int = 0,
                     group=None, retries: int = 3, backoff_s: float = 0.05,
                     sleep=None) -> "tuple[str, int]":
    """Stage this process's shards + the manifest and commit atomically.

    Waits for a :class:`Snapshot`'s device→host copies first. Returns
    ``(committed_path, bytes_written)``, the bytes this process wrote.

    Without ``group`` this process is the only writer: it stages its shard
    file and the manifest and renames. With ``group`` (a gloo process
    group of every writing process, core/sharded.py::gloo_twin;
    ``process_index`` is this process's rank in it) the commit is
    collective, and every process calls it in the same
    order: rank 0 names the staging directory and broadcasts it; each
    process stages ``shards_p{rank:04d}.npz`` there; rank 0 gathers every
    process's entries (the gather is the barrier: it returns once all have
    staged or failed), writes and fsyncs the manifest of all of them and
    renames; a broadcast of the outcome ends the save on every process, so
    a failure anywhere fails the save everywhere and nothing is committed.
    """
    sleep = sleep or time.sleep
    if isinstance(snapshot, Snapshot):
        snapshot.wait()
    final = os.path.join(directory, ckpt_name(round_idx))
    tmp = os.path.join(directory, f".tmp-{ckpt_name(round_idx)}-{os.getpid()}")
    fname = f"shards_p{process_index:04d}.npz"
    io_kw = dict(retries=retries, backoff_s=backoff_s, sleep=sleep)
    if group is not None:
        return _write_collective(final, tmp, fname, snapshot, round_idx,
                                 config, fs, process_index, group, io_kw)
    fs.makedirs(tmp)
    try:
        leaves, nbytes = _stage(tmp, fname, snapshot, fs, **io_kw)
        nbytes += _commit(tmp, final, round_idx, leaves, [fname], config, fs,
                          **io_kw)
    except BaseException as e:
        # a failed (not killed) save must not leave its temp dir to confuse
        # the NEXT save's staging; SimulatedKill skips even this cleanup,
        # exactly like a real process death would
        from repro_torch.robust.fs_faults import SimulatedKill

        if not isinstance(e, SimulatedKill):
            _drop_tmp(tmp, fs)
        raise
    return final, nbytes


def _write_collective(final, tmp, fname, snapshot, round_idx, config, fs,
                      rank: int, group, io_kw) -> "tuple[str, int]":
    """write_checkpoint's collective commit (see there)."""
    import torch.distributed as dist

    root = dist.get_global_rank(group, 0)
    name = [tmp if rank == 0 else None]
    dist.broadcast_object_list(name, src=root, group=group)
    tmp = name[0]
    staged, nbytes = None, 0
    try:
        fs.makedirs(tmp)
        leaves, nbytes = _stage(tmp, fname, snapshot, fs, **io_kw)
        staged = (fname, leaves)
    except Exception as e:   # a SimulatedKill ends this process's part
        staged = f"rank {rank}: {e!r}"
    gathered = [None] * dist.get_world_size(group) if rank == 0 else None
    dist.gather_object(staged, gathered, dst=root, group=group)
    outcome = [None]
    if rank == 0:
        failed = [g for g in gathered if isinstance(g, str)]
        try:
            if failed:
                raise OSError("; ".join(failed))
            merged: dict = {}
            for _, leaves in gathered:
                for key, rec in leaves.items():
                    if key in merged:
                        merged[key]["shards"].extend(rec["shards"])
                    else:
                        merged[key] = {**rec, "shards": list(rec["shards"])}
            nbytes += _commit(tmp, final, round_idx, merged,
                              [f for f, _ in gathered], config, fs, **io_kw)
        except Exception as e:
            _drop_tmp(tmp, fs)
            outcome = [f"checkpoint {final} not committed: {e!r}"]
    dist.broadcast_object_list(outcome, src=root, group=group)
    if outcome[0] is not None:
        raise OSError(outcome[0])
    return final, nbytes


def list_checkpoints(directory: str, fs: LocalFs = LOCAL_FS) \
        -> "list[tuple[int, str]]":
    """Committed checkpoints in ``directory``, newest round first. Garbage
    entries (tmp remnants, stray files) are ignored, never raised on."""
    if not fs.exists(directory):
        return []
    out = []
    for name in fs.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out, reverse=True)


def verify_checkpoint(path: str, fs: LocalFs = LOCAL_FS) \
        -> "tuple[dict, dict] | None":
    """Verify one committed checkpoint end-to-end.

    Returns ``(manifest, data)`` — ``data[leaf_key] = [(box, np.ndarray)]``
    — when the checkpoint is COMPLETE: manifest parses, every shard file
    exists, every entry's digest matches, every leaf's boxes tile its global
    shape. Returns None (with a logged reason) on any defect; never raises
    on garbage.
    """
    try:
        manifest = json.loads(fs.read_bytes(os.path.join(path, MANIFEST)))
    except (OSError, ValueError):
        logger.warning("checkpoint %s: missing/torn manifest — skipped", path)
        return None
    if not isinstance(manifest, dict) or manifest.get("format") != CKPT_FORMAT:
        logger.warning("checkpoint %s: unknown format %r — skipped", path,
                       manifest.get("format") if isinstance(manifest, dict)
                       else type(manifest).__name__)
        return None
    files = {}
    for fname in manifest.get("files", []):
        try:
            raw = fs.read_bytes(os.path.join(path, fname))
            files[fname] = np.load(io.BytesIO(raw))
        except (OSError, ValueError):
            logger.warning("checkpoint %s: shard file %s unreadable — "
                           "skipped", path, fname)
            return None
    data: "dict[str, list]" = {}
    try:
        for key, rec in manifest["leaves"].items():
            shape = tuple(rec["shape"])
            shards = []
            covered = 0
            for sm in rec["shards"]:
                npz = files.get(sm["file"])
                if npz is None or sm["entry"] not in npz.files:
                    logger.warning("checkpoint %s: leaf %s missing shard "
                                   "%s — skipped", path, key, sm["entry"])
                    return None
                arr = npz[sm["entry"]]
                if sha256_hex(arr.tobytes()) != sm["sha256"]:
                    logger.warning("checkpoint %s: leaf %s shard %s digest "
                                   "mismatch — skipped", path, key,
                                   sm["entry"])
                    return None
                box = tuple((int(a), int(b)) for a, b in sm["box"])
                vol = 1
                for (a, b), dim in zip(box, shape):
                    if not 0 <= a <= b <= dim:
                        logger.warning("checkpoint %s: leaf %s shard box out "
                                       "of range — skipped", path, key)
                        return None
                    vol *= b - a
                covered += vol
                shards.append((box, arr))
            total = int(np.prod(shape)) if shape else 1
            if covered != total:
                logger.warning("checkpoint %s: leaf %s shards cover %d of %d "
                               "elements — skipped (partial shard set)",
                               path, key, covered, total)
                return None
            data[key] = shards
    except (KeyError, TypeError, ValueError):
        logger.warning("checkpoint %s: malformed manifest — skipped", path)
        return None
    return manifest, data


def _assemble(like: Pytree, manifest: dict, data: "dict[str, list]",
              shard=None) -> Pytree:
    """Reassemble the tree of ``like`` from verified shard data, each leaf
    on the template leaf's device and in its dtype. Leaves the checkpoint
    holds and the template lacks are ignored. With ``shard`` (a
    ClientShard) ``like`` is the rank's state: each per-client leaf is
    assembled whole and the rank keeps its rows."""
    def leaf(key, tmpl):
        if key not in data:
            raise KeyError(f"checkpoint has no leaf {key!r} for the given "
                           "template (structure mismatch)")
        shape = tuple(manifest["leaves"][key]["shape"])
        want = _shape(tmpl)
        if shard is not None:
            want = shard.leaf_boxes(key, want)[0]
        if shape != want:
            raise ValueError(f"leaf {key}: checkpoint shape {shape} != "
                             f"template {want}")
        full = np.empty(shape, dtype=data[key][0][1].dtype)
        for box, arr in data[key]:
            idx = tuple(slice(a, b) for a, b in box)
            full[idx] = arr.reshape(full[idx].shape)
        if shard is not None and shard.per_client(key):
            full = full[shard.rows]
        return _to_like(full, tmpl)

    return _rebuild(like, leaf)


def _check_config(manifest: dict, expect_config: dict | None,
                  path: str) -> None:
    if not expect_config:
        return
    got = manifest.get("config", {})
    # the manifest round-tripped through JSON (tuples → lists, int keys →
    # str): normalize the expectation the same way before comparing
    expect = json.loads(json.dumps(expect_config))
    diff = {k: (got.get(k), v) for k, v in expect.items()
            if got.get(k) != v}
    if diff:
        detail = ", ".join(f"{k}: checkpoint={a!r} run={b!r}"
                           for k, (a, b) in sorted(diff.items()))
        raise CheckpointConfigMismatch(
            f"{path} was written by a different run configuration — "
            f"refusing to resume ({detail})")


def load_checkpoint(path: str, like: Pytree, fs: LocalFs = LOCAL_FS,
                    expect_config: dict | None = None, shard=None
                    ) -> "tuple[Pytree, dict]":
    """Verify + restore ONE committed checkpoint directory (explicit-path
    resume). Raises on any defect — an explicitly named checkpoint that
    fails verification is an error, not something to silently skip. With
    ``shard``, ``like`` is a rank's state and the rank's rows restore."""
    found = verify_checkpoint(path, fs=fs)
    if found is None:
        raise ValueError(f"checkpoint {path} is incomplete or corrupt")
    manifest, data = found
    _check_config(manifest, expect_config, path)
    return _assemble(like, manifest, data, shard), manifest


def load_latest(directory: str, like: Pytree, fs: LocalFs = LOCAL_FS,
                expect_config: dict | None = None, shard=None
                ) -> "tuple[Pytree, dict] | None":
    """Restore from the newest COMPLETE checkpoint under ``directory``.

    Walks the committed rounds newest-first, verifying each (digests, shard
    coverage); torn/corrupt/partial entries are skipped with a logged
    reason. Returns None when nothing restorable exists. A complete
    checkpoint whose config fingerprint mismatches ``expect_config`` raises
    :class:`CheckpointConfigMismatch` — resuming it would silently diverge.
    """
    for _, path in list_checkpoints(directory, fs=fs):
        found = verify_checkpoint(path, fs=fs)
        if found is None:
            continue
        manifest, data = found
        _check_config(manifest, expect_config, path)
        return _assemble(like, manifest, data, shard), manifest
    return None


def prune_checkpoints(directory: str, keep: int, fs: LocalFs = LOCAL_FS,
                      active_tmp: str | None = None) -> "list[str]":
    """Retention/GC: drop the oldest committed checkpoints beyond ``keep``
    and sweep dead ``.tmp-*`` staging remnants (crashed saves). ``active_tmp``
    names the one staging dir an in-flight save owns, which GC must not
    touch. Returns the removed paths."""
    removed = []
    if keep > 0:
        for _, path in list_checkpoints(directory, fs=fs)[keep:]:
            fs.rmtree(path)
            removed.append(path)
    if fs.exists(directory):
        for name in fs.listdir(directory):
            full = os.path.join(directory, name)
            if name.startswith(".tmp-") and full != active_tmp:
                fs.rmtree(full)
                removed.append(full)
    if removed:
        logger.info("checkpoint GC removed %d entries under %s",
                    len(removed), directory)
    return removed


__all__ = [
    "CKPT_FORMAT",
    "CheckpointConfigMismatch",
    "Snapshot",
    "ckpt_name",
    "inventory_of",
    "list_checkpoints",
    "load_checkpoint",
    "load_latest",
    "prune_checkpoints",
    "snapshot_shards",
    "verify_checkpoint",
    "write_checkpoint",
]
