"""Atomic filesystem commit protocol for checkpoints (a copy of
repro/checkpoint/atomic.py: pure Python, the same names and behaviour).

Every durable artifact this package writes goes through two rules:

  1. **write-temp-then-rename** — bytes land in a temp name on the same
     filesystem, are flushed AND fsync'd, and only then ``os.replace``d over
     the final name. A reader can observe the old file or the new file,
     never a torn hybrid. The same helper serves the legacy single-file npz
     path (checkpoint.py) and the sharded directory format (sharded_ckpt.py).
  2. **directory commit marker** — a multi-file checkpoint is staged in a
     ``.tmp-*`` directory; its manifest is written (fsync'd) LAST, then the
     whole directory is renamed into its final ``ckpt_<round>`` name. A
     checkpoint therefore exists completely or not at all: a crash at ANY
     byte of the save leaves either the previous committed set untouched or
     a ``.tmp-*`` remnant that discovery ignores and GC later removes.

All OS access goes through an injectable ``Fs`` object so the recovery
harness (robust/fs_faults.py) can deterministically inject torn
writes, ENOSPC, and process kills between save-start and commit. Production
code uses :data:`LOCAL_FS`, which is the plain ``os`` module behavior.

Transient I/O errors are retried with exponential backoff
(:func:`with_retries`); a persistent error (e.g. a truly full disk)
exhausts the retries and surfaces to the caller, which degrades gracefully
(the run continues, the failure is counted and alarmed — policy.py).
"""
from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time

logger = logging.getLogger("repro_torch.checkpoint")


class LocalFs:
    """The real filesystem. One method per OS primitive the checkpoint path
    needs, so a fault-injecting subclass can intercept each individually
    (robust/fs_faults.FaultyFs)."""

    def write_bytes(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> "list[str]":
        return os.listdir(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def rmtree(self, path: str) -> None:
        shutil.rmtree(path, ignore_errors=True)

    def fsync_dir(self, path: str) -> None:
        """Durably record a rename/creation in the parent directory entry
        (POSIX: fsync the directory fd). Best-effort on platforms without
        directory fds."""
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


LOCAL_FS = LocalFs()


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def with_retries(fn, *, retries: int = 3, backoff_s: float = 0.05,
                 sleep=time.sleep, what: str = "io"):
    """Run ``fn()``, retrying transient OSErrors with exponential backoff.

    ``retries`` is the number of RE-tries (retries=3 → up to 4 attempts).
    Non-OSError exceptions propagate immediately — a SimulatedKill from the
    crash-injection harness must behave like a process death, not a flaky
    disk.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            logger.warning("checkpoint %s failed (%s); retry %d/%d in %.3fs",
                           what, e, attempt + 1, retries, delay)
            sleep(delay)
            attempt += 1


def write_bytes_atomic(path: str, data: bytes, fs: LocalFs = LOCAL_FS,
                       retries: int = 3, backoff_s: float = 0.05,
                       sleep=time.sleep) -> None:
    """Write ``data`` to ``path`` via temp-file + fsync + rename: a reader
    (or a crash) never observes a torn ``path``. The temp name carries the
    pid so two writers cannot collide on it."""
    fs.makedirs(os.path.dirname(path) or ".")
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with_retries(lambda: fs.write_bytes(tmp, data),
                     retries=retries, backoff_s=backoff_s, sleep=sleep,
                     what=f"write {os.path.basename(path)}")
        with_retries(lambda: fs.replace(tmp, path),
                     retries=retries, backoff_s=backoff_s, sleep=sleep,
                     what=f"commit {os.path.basename(path)}")
    except BaseException:
        if fs.exists(tmp):
            try:
                fs.rmtree(tmp)
            except OSError:
                pass
        raise
    fs.fsync_dir(os.path.dirname(path) or ".")


def commit_dir(tmp_dir: str, final_dir: str, fs: LocalFs = LOCAL_FS,
               retries: int = 3, backoff_s: float = 0.05,
               sleep=time.sleep) -> None:
    """Atomically publish a fully-staged checkpoint directory. The rename is
    the commit point — everything before it is invisible to discovery."""
    with_retries(lambda: fs.replace(tmp_dir, final_dir),
                 retries=retries, backoff_s=backoff_s, sleep=sleep,
                 what=f"commit {os.path.basename(final_dir)}")
    fs.fsync_dir(os.path.dirname(final_dir) or ".")


__all__ = ["LOCAL_FS", "LocalFs", "commit_dir", "sha256_hex",
           "with_retries", "write_bytes_atomic"]
