"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc/*.cu`` are compiled by ONE ``nvcc``
call into one shared library with a plain C interface, loaded with ctypes
(no PyTorch headers, so the build takes seconds). The build runs at first
use, never at import, into ``<repo>/build/kernels/`` (listed in
.gitignore), keyed by a hash of the sources and flags so an edited source
rebuilds. Each C entry point returns ``cudaGetLastError()`` right after its
launch; ``launch`` raises if that is not 0.

``LAUNCHES`` counts launches per kernel. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (chip_smoke.py resets and reads it).
"""
from __future__ import annotations

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel name → launches since the last reset (see module docstring)
LAUNCHES = {"trajectory": 0, "gram": 0, "update": 0}

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
#: C entry points → argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    # dtype, link, anchor, x, y, mask, w0, u, invn, w_traj, r_traj,
    # K, S, n, d, steps, eta, reg, stream
    "repro_trajectory": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _D, _D, _P],
    # dtype, y, g, g_stride, gram, yg, K, m, d, stream
    "repro_gram": [_I, _P, _P, _LL, _P, _P, _I, _I, _I, _P],
    # dtype, w, w_stride, g, g_stride, s, y, gamma, out, K, m, d, eta, beta,
    # stream
    "repro_update": [_I, _P, _LL, _P, _LL, _P, _P, _P, _P, _I, _I, _I,
                     _D, _D, _P],
}

_lib = None
_lock = threading.Lock()
#: seconds the last build took (None: the library was already built)
build_seconds: float | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from csrc/ at first use")


def build() -> Path:
    """Compile csrc/*.cu into one library (once per source hash); returns
    its path."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"repro_torch: nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


#: dtype → the C entry points' dtype code
DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is a contiguous f32/f64 CUDA tensor on one
    compute-capability-9.x card; returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{name}: the kernel takes float32 or float64, "
                            f"got {t.dtype}")
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(dev)} is "
                           f"sm_{major}{minor}")
    return dev


def launch(name: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` on the current stream; raise on error."""
    lib = library()
    err = getattr(lib, entry)(*args,
                              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1
