"""Build and load the port's CUDA kernels.

Each source ``repro_torch/csrc/*.cu`` is compiled by its own ``nvcc``, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so the build takes seconds). The build runs at first use, never at import,
into ``<repo>/build/kernels/`` (listed in .gitignore), keyed by a hash of
the sources and flags so an edited source rebuilds. ``build_timing.py``
times this build against one nvcc for all sources. Each C entry point
returns ``cudaGetLastError()`` right after its launch; ``launch`` raises
if that is not 0.

``LAUNCHES`` counts launches per kernel that reached the card. Each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels (chip_smoke.py resets
and reads it). ``DESIGN_LAUNCHES`` splits those of a kernel with more than
one design (``trajectory``: resident or streaming; ``gram``: block or
split) by the design that ran.
A launch made while a CUDA graph is captured does not run: inside
``recording()`` it goes into a ``LaunchRecord``, and each replay of the
graph adds that record to both counters (``count_replay``); outside one it
raises, so no replay goes uncounted. ``noop`` launches an empty kernel
through the same path, counted nowhere: timed back to back, it is the
launch floor every kernel's time includes. ``host_node`` enqueues a host
function on the current stream (a host node of a captured graph: the
engine's live tap), which is no kernel and is counted nowhere.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

#: kernel name → launches since the last reset (see module docstring)
LAUNCHES = {"trajectory": 0, "gram": 0, "update": 0, "aa_step": 0,
            "quantize": 0, "dequantize": 0, "int8_uplink": 0, "ssd": 0,
            "flash_attention": 0}
#: kernel → design → launches since the last reset (see module docstring)
DESIGN_LAUNCHES = {"trajectory": {"resident": 0, "streaming": 0},
                   "gram": {"block": 0, "split": 0}}

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
#: C entry points → argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    # dtype, link, anchor, x, y, mask, w0, u, invn, w_traj, r_traj,
    # K, S, n, d, steps, cluster, eta, reg, stream
    "repro_trajectory": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _D, _D, _P],
    # dtype, y, g, g_stride, gram, yg, K, m, d, stream
    "repro_gram": [_I, _P, _P, _LL, _P, _P, _I, _I, _I, _P],
    # dtype, y, g, g_stride, gram, yg, ws, K, m, d, parts, stream
    "repro_gram_split": [_I, _P, _P, _LL, _P, _P, _P, _I, _I, _LL, _I, _P],
    # dtype, w, w_stride, g, g_stride, s, y, gamma, out, K, m, d, eta, beta,
    # stream
    "repro_update": [_I, _P, _LL, _P, _LL, _P, _P, _P, _P, _I, _I, _I,
                     _D, _D, _P],
    # dtype, w, w_stride, g, g_stride, s, y, gram, yg, out, gamma, stats,
    # counts, gnorm2, K, m, d, blocks, eta, beta, tikhonov, filter_rtol,
    # clip_rtol, stream
    "repro_aa_step": [_I, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _D, _D, _D, _D, _D, _P],
    # x_dtype, x, n, u, q, scales, B, nc, C, stream
    "repro_quantize": [_I, _P, _LL, _P, _P, _P, _I, _I, _I, _P],
    # out_dtype, q, scales, out, n, B, nc, C, stream
    "repro_dequantize": [_I, _P, _P, _P, _LL, _I, _I, _I, _P],
    # dtype, x, anchor, ref, ef, post, u, dec, new_e, new_h, n, B, nc, C,
    # stream
    "repro_int8_uplink": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                          _I, _P],
    # x, dt, da, B, C, cb, y, state, G, Q, nh, hd, st, stream
    "repro_ssd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, q, k, v, out, B, S, H, KV, d, causal, window, stream
    "repro_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P],
    # stream
    "repro_noop": [_P],
    # fn, data, stream
    "repro_host_node": [_P, _P, _P],
}
#: what an occupancy query's int array holds (see occupancy)
_BLOCK_FIELDS = ("blocks_per_sm", "registers", "shared_bytes", "threads",
                 "local_bytes")
_CLUSTER_FIELDS = ("active_clusters", "shared_bytes", "threads", "registers")
#: occupancy queries (no launch) → (argtypes: the kernel's arguments, then
#: the int array it fills; that array's fields)
_OCCUPANCY = {
    # dtype, d
    "repro_flash_occupancy": ([_I, _I, _P], _BLOCK_FIELDS),
    # dtype, m, d
    "repro_gram_occupancy": ([_I, _I, _I, _P], _BLOCK_FIELDS),
    # Q, hd, st
    "repro_ssd_occupancy": ([_I, _I, _I, _P], _BLOCK_FIELDS),
    # dtype, link, anchor, n, d, cluster
    "repro_trajectory_clusters": ([_I, _I, _I, _I, _I, _I, _P], _CLUSTER_FIELDS),
}

_lib = None
_lock = threading.Lock()
#: seconds the last build took (None: the library was already built)
build_seconds: float | None = None


class LaunchRecord:
    """Launches counted apart from ``LAUNCHES``: kernel → launches and
    kernel → design → launches, as ``recording()`` collected them."""

    def __init__(self):
        self.launches: dict[str, int] = {}
        self.designs: dict[str, dict[str, int]] = {}

    def add(self, name: str, design: str | None) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        if design is not None:
            by_design = self.designs.setdefault(name, {})
            by_design[design] = by_design.get(design, 0) + 1


#: where launches go instead of LAUNCHES while ``recording()`` is open
_record: LaunchRecord | None = None


@contextlib.contextmanager
def recording():
    """Count the launches made inside into a fresh ``LaunchRecord`` (the
    value of the ``with``) instead of ``LAUNCHES``: a CUDA graph's capture,
    whose replays then add it (``count_replay``), or set-up work reported
    apart from a run's counts."""
    global _record
    outer, _record = _record, LaunchRecord()
    try:
        yield _record
    finally:
        _record = outer


def count_replay(record: LaunchRecord) -> None:
    """One replay of a graph captured under ``recording()``: its launches
    reached the card, so add them to ``LAUNCHES`` and ``DESIGN_LAUNCHES``."""
    for name, n in record.launches.items():
        LAUNCHES[name] += n
    for name, designs in record.designs.items():
        for design, n in designs.items():
            DESIGN_LAUNCHES[name][design] += n


def _capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for designs in DESIGN_LAUNCHES.values():
        for design in designs:
            designs[design] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from csrc/ at first use")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's output
    once every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out}\n{err}")
    if errors:
        raise RuntimeError(f"repro_torch: nvcc failed:\n{errors[0]}")


def compile_library(out: Path) -> None:
    """Compile every csrc/*.cu into the shared library ``out``: one nvcc
    per source, all started together, then one link."""
    nvcc = _nvcc()
    objdir = out.parent / f"obj.{out.name}"
    objdir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objs = [objdir / f"{src.stem}.o" for src in sources]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                   str(src)] for src, o in zip(sources, objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                   *map(str, objs)]])
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


def build() -> Path:
    """Compile csrc/*.cu into one library (once per source hash); returns
    the library's path."""
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    compile_library(tmp)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            entries = _SIGNATURES | {k: v[0] for k, v in _OCCUPANCY.items()}
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


#: dtype → the C entry points' dtype code
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes=(torch.float32, torch.float64)) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` (f32/f64 by default) on one compute-capability-9.x card;
    returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {dtypes}, got "
                            f"{t.dtype}")
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(dev)} is "
                           f"sm_{major}{minor}")
    return dev


def occupancy(entry: str, *args) -> dict:
    """What the card makes of the kernel that C entry point ``entry``
    (a key of _OCCUPANCY) resolves for ``args``, without launching it: for
    a block, resident blocks per SM, registers a thread, shared bytes a
    block, threads a block, local (spilled) bytes a thread; for a cluster,
    the clusters resident at once, shared bytes, threads and registers."""
    lib = library()
    fields = _OCCUPANCY[entry][1]
    info = (ctypes.c_int * len(fields))()
    err = getattr(lib, entry)(*args, info)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: {msg} ({err})")
    return dict(zip(fields, info))


def _call(name: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` on the current stream; raise on error."""
    lib = library()
    err = getattr(lib, entry)(*args,
                              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")


def launch(name: str, entry: str, *args, design: str | None = None) -> None:
    """Call C entry point ``entry`` on the current stream, raise on error,
    and count the launch: in ``LAUNCHES``, or in the open ``recording()``.
    ``design`` names the design that runs, for a kernel with more than
    one."""
    _call(name, entry, *args)
    if _record is not None:
        _record.add(name, design)
        return
    if _capturing():
        raise RuntimeError(f"{name}: launched while a CUDA graph is captured "
                           "outside _build.recording(); its replays would go "
                           "uncounted")
    LAUNCHES[name] += 1
    if design is not None:
        DESIGN_LAUNCHES[name][design] += 1


def noop() -> None:
    """Launch the empty kernel (one warp, no memory traffic) on the current
    stream, the way ``launch`` launches every kernel; counted nowhere."""
    _call("noop", "repro_noop")


#: the C signature of a host function: void fn(void* data)
HOST_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def host_node(fn, data: int) -> None:
    """Enqueue ``fn(data)`` (a ``HOST_FN``) on the current stream
    (``cudaLaunchHostFunc``); under capture, a host node of the graph. The
    stream's later work waits for ``fn`` to return, and ``fn`` runs on
    CUDA's callback thread, so it must call no CUDA API. The caller keeps
    ``fn`` alive as long as the stream or graph may run it. No kernel, so
    counted nowhere."""
    _call("host_node", "repro_host_node", fn, ctypes.c_void_p(data))
