#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler window over three paper-scale rounds
after phase 4 (device time by kernel, the device's busy share).

Needs one CUDA card of compute capability 9.x (H100) and ``nvcc``; it
builds the port's three CUDA kernels from ``src/repro_torch/csrc`` and exits
non-zero, printing no result, where there is no card or no port beside it.
Every phase raises on failure; none is caught.

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the kernels' build time.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (K=100 clients x 5810 rows, d=54, 11 local steps, m=10
   history columns), in float64 and float32: the largest difference relative
   to the plain result's largest magnitude must stay within 1e-12 (float64)
   and 1e-5 (float32) -- the two differ only in summation order, no solve
   is involved. Where a result may cancel (Y g, the update), the difference
   is taken relative to the sum of the absolute values of its terms. The
   update is held twice: with the AA solve's coefficients (large, from an
   ill-conditioned Gram) and with coefficients of order 1, where every
   term, the -eta g term included, weighs on the result.
   Times come from CUDA events (median of repeats).
3. The acceptance configuration (synthetic covtype n=10,000, K=10 iid,
   gamma=1e-3, eta=1, L=10, float64, FedOSAA-SVRG, at most 20 rounds):
   every kernel launches once per round, rel-error 1e-6 within 18 rounds,
   final loss within rel 1e-12 of the JAX reference's 0.3031490665062957.
4. Paper scale (covtype-sized synthetic data N=581,012, d=54, K=100 iid,
   10 rounds, float64 and float32): ms per round and the rel-error reached.
   These are the main path's runs: the launch counters are set to 0 just
   before each dtype's run and read just after it, and every kernel must
   have launched once per round of that run. The kernels line reports the
   float64 run's counts as ``launches`` and both runs' in
   ``launches_by_dtype``.
5. The kernels line, then ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: HBM rate, and the peak rate of each type's
#: fastest unit (float32 outside the tensor cores; float64 on the FP64
#: tensor cores) -- the least time the card could take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
#: kernel vs plain: max |kernel - plain| over the result's (or its terms')
#: largest magnitude; the two differ in summation order only
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
#: the JAX reference's converged loss on the acceptance configuration
#: (benchmarks/results/ext_robustness.json, identity/clean/off)
REFERENCE_LOSS = 0.3031490665062957
#: main-path shapes
K_MAIN, N_PAPER, D, L_EPOCHS = 100, 581_012, 54, 10
ETA, GAMMA = 1.0, 1e-3

KERNELS = {
    "trajectory": ("src/repro_torch/csrc/trajectory.cu",
                   "src/repro/kernels/local_update/local_update.py:128"),
    "gram": ("src/repro_torch/csrc/gram.cu",
             "src/repro/kernels/anderson/anderson.py:52"),
    "update": ("src/repro_torch/csrc/update.cu",
               "src/repro/kernels/anderson/anderson.py:101"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, device, n: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``n`` back-to-back
    calls of ``fn``, from CUDA events. A sleep kernel ahead of the timed
    calls lets the host enqueue them all before the card reaches them, so
    host overhead between calls is not timed."""
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)   # ~0.1 s at the H100's clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_diff(a: torch.Tensor, b: torch.Tensor,
             scale: torch.Tensor | None = None) -> tuple[float, float]:
    """(max |a - b| / max scale, max |a - b|). The scale is the sum of the
    absolute values of the terms summed where the result may cancel (a
    sum's rounding error grows with those, not with the result), else |b|."""
    err = float((a - b).abs().max())
    scale = b.abs() if scale is None else scale
    return err / max(float(scale.max()), 1e-300), err


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(clients, dtype, device) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes and on its data (the paper-scale clients, a trajectory from a
    random anchor, the AA solve's coefficients)."""
    from repro_torch.core.anderson import AAConfig, _solve_gram, trajectory_to_sy
    from repro_torch.kernels.anderson import flat_gram, flat_update
    from repro_torch.kernels.anderson.ref import gram_ref, update_ref
    from repro_torch.kernels.local_update import fused_trajectory
    from repro_torch.kernels.local_update.ops import inverse_count
    from repro_torch.kernels.local_update.ref import trajectory_ref

    gen = torch.Generator(device=device).manual_seed(0)
    x = clients.x.to(dtype)[:, None]           # [K, 1, n, d], resident design
    y = clients.y.to(dtype)[:, None]
    mask = clients.mask.to(dtype)[:, None]
    K, _, n, d = x.shape
    steps = L_EPOCHS + 1
    w0 = 0.1 * torch.randn(K, d, generator=gen, device=device, dtype=dtype)
    u = 0.01 * torch.randn(K, d, generator=gen, device=device, dtype=dtype)
    invn = inverse_count(mask, dtype)
    kw = dict(link="logistic", reg=GAMMA, eta=ETA, anchor_scale=1.0, steps=steps)

    def kernel_traj():
        return fused_trajectory(x, y, mask, w0, u, **kw)

    def plain_traj():
        return trajectory_ref(x, y, mask, w0, u, invn, **kw)

    results = {}
    wk, rk = kernel_traj()
    wp, rp = plain_traj()
    errs = [rel_diff(wk, wp), rel_diff(rk, rp)]
    results["trajectory"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(kernel_traj, device), plain_ms=device_ms(plain_traj, device),
        library_ms=None,
        bound=bound_ms(nbytes(x, y, mask, w0, u, invn, wk, rk),
                       # live logits and X^T c every step, anchor logits once
                       K * n * d * (4 * steps + 2), dtype))

    s, ys = trajectory_to_sy(wp, rp)               # [K, m, d] each
    g = 0.01 * torch.randn(d, generator=gen, device=device, dtype=dtype)
    m = ys.shape[1]

    gk, ygk = flat_gram(ys, g)
    gp, ygp = gram_ref(ys, g)
    ya = ys.abs()
    errs = [rel_diff(gk, gp),
            rel_diff(ygk, ygp, (ya @ g.abs().unsqueeze(-1)).squeeze(-1))]
    # one torch call for both outputs: Y_k [Y_k^T | g] per client
    rhs = torch.cat([ys, g.expand(K, 1, d)], 1).transpose(1, 2).contiguous()
    results["gram"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(lambda: flat_gram(ys, g), device),
        plain_ms=device_ms(lambda: gram_ref(ys, g), device),
        library_ms=device_ms(lambda: torch.bmm(ys, rhs), device),
        bound=bound_ms(nbytes(ys, g, gk, ygk),
                       K * d * 2 * (m * (m + 1) // 2 + m), dtype))

    gamma = _solve_gram(gp, ygp, AAConfig())[0]
    w = 0.1 * torch.randn(d, generator=gen, device=device, dtype=dtype)
    errs = []
    # the solve's coefficients, then coefficients of order 1: with the
    # former (|gamma| ~ 1e4) the S^T gamma and Y^T gamma terms dwarf eta g
    for coef in (gamma, torch.randn(K, m, generator=gen, device=device,
                                    dtype=dtype)):
        ok = flat_update(w, g, s, ys, coef, ETA, 1.0)
        op = update_ref(w, g, s, ys, coef, ETA, 1.0)
        ga = coef.abs().unsqueeze(-2)
        errs.append(rel_diff(ok, op, w.abs() + ETA * g.abs() + (
            ga @ s.abs() + ETA * (ga @ ya)).squeeze(-2)))
    results["update"] = dict(
        rel=max(e[0] for e in errs), abs=max(e[1] for e in errs),
        ms=device_ms(lambda: flat_update(w, g, s, ys, gamma, ETA, 1.0), device),
        plain_ms=device_ms(lambda: update_ref(w, g, s, ys, gamma, ETA, 1.0),
                           device),
        library_ms=None,
        bound=bound_ms(nbytes(w, g, s, ys, gamma, ok), K * d * (4 * m + 4), dtype))

    for name, r in results.items():
        print(f"  {name:10s} {str(dtype)[6:]:7s} rel {r['rel']:.3e} "
              f"abs {r['abs']:.3e}  kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)
        if not r["rel"] <= TOLERANCE[dtype]:
            raise AssertionError(
                f"{name} kernel disagrees with its plain version in {dtype}: "
                f"{r['rel']:.3e} > {TOLERANCE[dtype]:.0e}")
    return results


def acceptance(device) -> dict:
    """Phase 3: the acceptance configuration through the kernels."""
    from repro_torch.core import AlgoHParams, run_federated, solve_reference
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    X, y = make_binary_classification("covtype", n=10_000, seed=0)
    clients = partition(X, y, 10, "iid", seed=0, device=device)
    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    w_star = solve_reference(prob, iters=100)
    _build.reset_launches()
    h = run_federated(prob, "fedosaa_svrg", AlgoHParams(eta=ETA, local_epochs=L_EPOCHS),
                      20, w_star=w_star, stop_rel_error=1e-8, device=device)
    launches = dict(_build.LAUNCHES)
    rounds = len(h.rounds)
    hit = np.nonzero(h.rel_error < 1e-6)[0]
    to_target = int(hit[0]) + 1 if len(hit) else None
    loss_rel = abs(h.loss[-1] - REFERENCE_LOSS) / REFERENCE_LOSS
    print(f"  rounds run {rounds}, rounds to rel-error 1e-6: {to_target}, "
          f"final loss {h.loss[-1]!r} (rel {loss_rel:.2e} from the reference), "
          f"launches {launches}", flush=True)
    print("  rel-error curve " + json.dumps([float(v) for v in h.rel_error]),
          flush=True)
    if any(launches[k] != rounds for k in launches):
        raise AssertionError(f"each kernel must launch once per round: "
                             f"{launches} over {rounds} rounds")
    if to_target is None or to_target > 18:
        raise AssertionError(f"rel-error 1e-6 not reached within 18 rounds "
                             f"({to_target})")
    if not loss_rel <= 1e-12:
        raise AssertionError(f"final loss {h.loss[-1]!r} is {loss_rel:.2e} "
                             f"from {REFERENCE_LOSS!r}")
    return dict(rounds=rounds, to_target=to_target, loss=float(h.loss[-1]))


def paper_scale(clients, w_star, device) -> dict:
    """Phase 4: the main path at the paper's covtype size, both dtypes.
    Each dtype's run is read on its own launch counts: they are set to 0
    just before it and must equal its rounds just after."""
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    out = {}
    for dtype in (torch.float64, torch.float32):
        prob = make_logreg_problem(clients, GAMMA, dtype=dtype, device=device)
        _build.reset_launches()
        h = run_federated(prob, "fedosaa_svrg",
                          AlgoHParams(eta=ETA, local_epochs=L_EPOCHS), 10,
                          w_star=w_star.to(dtype), device=device)
        launches = dict(_build.LAUNCHES)
        rounds = len(h.rounds)
        per_round = np.diff(h.wall_time) * 1e3      # round 0 excluded
        name = str(dtype)[6:]
        out[name] = dict(ms_per_round=float(np.median(per_round)),
                         rel_error=float(h.rel_error[-1]), rounds=rounds,
                         launches=launches)
        print(f"  {name}: {rounds} rounds, median {out[name]['ms_per_round']:.3f} "
              f"ms/round (round 0: {h.wall_time[0] * 1e3:.1f} ms), rel-error "
              f"{h.rel_error[-1]:.3e}, loss {h.loss[-1]!r}, launches "
              f"{launches}", flush=True)
        if sorted(launches) != sorted(KERNELS) or any(
                v != rounds for v in launches.values()):
            raise AssertionError(f"paper-scale {name} run: each kernel must "
                                 f"launch once per round: {launches} over "
                                 f"{rounds} rounds")
        if not (np.all(np.isfinite(h.loss)) and h.rel_error[-1] < h.rel_error[0]):
            raise AssertionError(f"paper-scale {name} run did not converge: "
                                 f"{h.rel_error.tolist()}")
    return out


def profile_rounds(clients, device, rounds: int = 3) -> None:
    """``--profile``: torch.profiler over a few paper-scale f64 rounds after
    two warm-up rounds; prints device time by kernel and the device's busy
    share of the wall time (a diagnostic, not a phase of the smoke run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AlgoHParams, init_state, make_round_fn
    from repro_torch.models.logreg import make_logreg_problem

    prob = make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device)
    round_fn = make_round_fn("fedosaa_svrg", prob,
                             AlgoHParams(eta=ETA, local_epochs=L_EPOCHS), device)
    state = init_state(prob, device=device)
    for _ in range(2):
        state, m = round_fn(state)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, m = round_fn(state)
            float(m.loss)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # kernels only: an operator's row repeats its kernels' time
    busy_us = sum(getattr(e, key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(events.table(sort_by=key, row_limit=25), flush=True)
    print(f"  profile: {rounds} rounds, wall {wall * 1e3 / rounds:.3f} ms/round, "
          f"device busy {busy_us / 1e3 / rounds:.3f} ms/round "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the wall)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import solve_reference
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.kernels import _build
    from repro_torch.models.logreg import make_logreg_problem

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, sm_"
          f"{''.join(map(str, torch.cuda.get_device_capability(0)))}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built in {_build.build_seconds or 0.0:.1f} s "
          f"(nvcc), loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    X, y = make_binary_classification("covtype", n=N_PAPER, seed=0)
    clients = partition(X, y, K_MAIN, "iid", seed=0, device=device)
    print(f"  paper-scale data: N={N_PAPER}, K={K_MAIN}, n_k="
          f"{clients.x.shape[1]}, d={clients.x.shape[2]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    checks = {dt: check_kernels(clients, dt, device)
              for dt in (torch.float64, torch.float32)}

    print("phase 3: acceptance configuration (n=10,000, K=10, float64)",
          flush=True)
    acceptance(device)

    print("phase 4: paper scale (N=581,012, K=100)", flush=True)
    t0 = time.perf_counter()
    w_star = solve_reference(
        make_logreg_problem(clients, GAMMA, dtype=torch.float64, device=device),
        iters=100)
    print(f"  w* by Newton-CG in {time.perf_counter() - t0:.1f} s", flush=True)
    paper = paper_scale(clients, w_star, device)
    if "--profile" in sys.argv[1:]:
        profile_rounds(clients, device)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = checks[torch.float64][name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paper["float64"]["launches"][name],
            launches_by_dtype={dt: paper[dt]["launches"][name] for dt in paper},
            max_abs_err=r["abs"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    f32 = {name: {k: v for k, v in r.items()}
           for name, r in checks[torch.float32].items()}
    print("float32 kernels " + json.dumps(f32), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
