"""The Newton family (GIANT, Newton-GMRES, DANE) on the JAX reference,
ext_compression's configuration (synthetic covtype n=20,000, K=20 iid,
gamma=1e-3, eta=1, L=10, float64, default DANE iterations, to rel-error
1e-6 with a cap of 40 rounds) on the fp32 wire, with its tree_math helpers
as they are (they accumulate CG's and DANE's dot products in float32) and
with float64 ones patched in, as the port's parity tests patch them.
Prints each run's rounds and rel-error curve beside the committed row
(benchmarks/results/ext_compression.json, fp32/<algo>).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/reference_newton_rows.py
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.utils.tree_math as tm
from benchmarks.common import logreg_setup
from repro.core import AlgoHParams, run_federated

ALGOS = ("giant", "newton_gmres", "dane")
F64_HELPERS = {
    "tree_dot": lambda a, b: jnp.sum(a * b),
    "tree_vdot_stacked": lambda s, v: s @ v,
    "tree_gram": lambda a, b: a @ b.T,
    "tree_combine_stacked": lambda s, c: c @ s,
}


def run(prob, w_star, algo: str) -> dict:
    h = run_federated(prob, algo, AlgoHParams(eta=1.0, local_epochs=10), 40,
                      w_star=w_star, channel="fp32", stop_rel_error=1e-6)
    rel = np.asarray(h.rel_error)
    return dict(rounds=len(rel), curve=[float(v) for v in rel],
                loss=float(h.loss[-1]))


def main() -> None:
    jax.config.update("jax_enable_x64", True)
    prob, w_star = logreg_setup("covtype", n=20_000, k=20, dtype="float64")
    rows = {r["name"]: r for r in json.loads(
        (Path(__file__).resolve().parents[1] / "benchmarks" / "results"
         / "ext_compression.json").read_text())}
    out = {}
    for algo in ALGOS:
        out[algo] = {"as_is": run(prob, w_star, algo)}
        saved = {name: getattr(tm, name) for name in F64_HELPERS}
        try:
            for name, fn in F64_HELPERS.items():
                setattr(tm, name, fn)
            out[algo]["f64_helpers"] = run(prob, w_star, algo)
        finally:
            for name, fn in saved.items():
                setattr(tm, name, fn)
        c = rows[f"ext_compression/fp32/{algo}"]
        out[algo]["committed"] = dict(rounds=c["rounds"],
                                      curve=c["rel_error_curve"],
                                      loss=c["final_loss"])
        print(json.dumps({algo: out[algo]}), flush=True)


if __name__ == "__main__":
    main()
