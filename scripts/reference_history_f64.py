"""The byzantine-history attack of ext_robustness on the JAX reference
(benchmarks/ext_robustness.py's quick configuration: synthetic covtype
n=10,000, K=10 iid, gamma=1e-3, eta=1, L=10, float64, FedOSAA-SVRG, one
history client at byz_scale 1e24, at most 40 rounds, stopping at rel-error
1e-8), undefended and with clip_rtol=1e-3, and the clean run, with its
tree_math helpers as they are (they accumulate the AA step's products in
float32, whose Gram overflows at this scale) and with float64 ones patched
in (the port's accumulation). Prints each run's rounds, finiteness and
rounds to rel-error 1e-4 and 1e-6, beside the committed rows
(benchmarks/results/ext_robustness.json, identity/history/off and on).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_history_f64.py
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.utils.tree_math as tm
from repro.core import AlgoHParams, run_federated, solve_reference
from repro.core.anderson import AAConfig
from repro.data import make_binary_classification, partition
from repro.models.logreg import make_logreg_problem
from repro.robust import FaultPlan

F64_HELPERS = {
    "tree_dot": lambda a, b: jnp.sum(a * b),
    "tree_vdot_stacked": lambda s, v: s @ v,
    "tree_gram": lambda a, b: a @ b.T,
    "tree_combine_stacked": lambda s, c: c @ s,
}
PLAN = FaultPlan(byz_clients=1, byz_mode="history", byz_scale=1e24)


def rounds_to(rel, target):
    hit = np.nonzero(rel < target)[0]
    return int(hit[0]) + 1 if len(hit) else None


def run(prob, w_star, clip, faults) -> dict:
    h = run_federated(prob, "fedosaa_svrg",
                      AlgoHParams(eta=1.0, local_epochs=10,
                                  aa=AAConfig(clip_rtol=clip)), 40,
                      w_star=w_star, stop_rel_error=1e-8, faults=faults)
    rel = np.asarray(h.rel_error)
    return dict(rounds=len(rel), finite=bool(np.isfinite(h.loss).all()),
                to_1e4=rounds_to(rel, 1e-4), to_1e6=rounds_to(rel, 1e-6))


def runs(prob, w_star) -> dict:
    return {"history/off": run(prob, w_star, 0.0, PLAN),
            "history/on": run(prob, w_star, 1e-3, PLAN),
            "clean/off": run(prob, w_star, 0.0, None)}


def main() -> None:
    jax.config.update("jax_enable_x64", True)
    X, y = make_binary_classification("covtype", n=10_000, seed=0)
    prob = make_logreg_problem(partition(X, y, 10, "iid", seed=0), 1e-3,
                               dtype=jnp.float64)
    w_star = solve_reference(prob, iters=100)
    out = {"as_is": runs(prob, w_star)}
    saved = {name: getattr(tm, name) for name in F64_HELPERS}
    try:
        for name, fn in F64_HELPERS.items():
            setattr(tm, name, fn)
        out["f64_helpers"] = runs(prob, w_star)
    finally:
        for name, fn in saved.items():
            setattr(tm, name, fn)
    rows = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                       / "results" / "ext_robustness.json").read_text())
    out["committed"] = {
        r["name"].removeprefix("ext_robustness/identity/"): dict(
            rounds=r["rounds"], to_1e6=r["rounds_to_target"],
            finite=r["finite"])
        for r in rows if r["name"] in (
            "ext_robustness/identity/history/off",
            "ext_robustness/identity/history/on",
            "ext_robustness/identity/clean/off")}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
