"""Time the kernel library's build: one nvcc per source started together
plus a link (``_build.compile_library``, what the port uses) against one
nvcc that compiles every source into the library in one call.

    PYTHONPATH=src python -m repro_torch.kernels.build_timing [--repeats N]

Every build is cold (nvcc keeps no cache) and goes to a fresh directory
under ``build/``; the two ways alternate (one, parallel, parallel, one,
...) so a drift of the machine weighs on both. Prints each time and, as
the last line, a JSON object with both lists of seconds and the card's
nvidia-smi name and power limit. Needs nvcc; runs no kernel.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

from repro_torch.kernels import _build


def _one_call(out) -> None:
    sources = sorted(_build.CSRC.glob("*.cu"))
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                      "-shared", "-o", str(out), *map(str, sources)]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    root = _build.BUILD_DIR.parent / "build_timing"
    ways = {"one_nvcc": _one_call, "parallel": _build.compile_library}
    order = [w for i in range(args.repeats)
             for w in (("one_nvcc", "parallel") if i % 2 == 0
                       else ("parallel", "one_nvcc"))]
    seconds = {w: [] for w in ways}
    try:
        for i, way in enumerate(order):
            out_dir = root / f"{i}_{way}"
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            ways[way](out_dir / "librepro_torch.so")
            seconds[way].append(time.perf_counter() - t0)
            print(f"{way:9s} {seconds[way][-1]:.3f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"build_seconds": seconds,
                      "sources": len(list(_build.CSRC.glob("*.cu"))),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
