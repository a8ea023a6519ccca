"""FedOSAA-SCAFFOLD on the JAX reference, ext_compression's configuration
(synthetic covtype n=20,000, K=20 iid, gamma=1e-3, eta=1, L=10, float64,
the fp32 wire, 200 rounds), with its tree_math helpers as they are (they
accumulate the AA step's products in float32) and with float64 ones patched
in, as the port's parity tests patch them. Prints the final and the least
rel-error of each, beside the committed row
(benchmarks/results/ext_compression.json, fp32/fedosaa_scaffold).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fedosaa_scaffold.py
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.utils.tree_math as tm
from repro.core import AlgoHParams, run_federated, solve_reference
from repro.data import make_binary_classification, partition
from repro.models.logreg import make_logreg_problem

ROUNDS = 200
F64_HELPERS = {
    "tree_dot": lambda a, b: jnp.sum(a * b),
    "tree_vdot_stacked": lambda s, v: s @ v,
    "tree_gram": lambda a, b: a @ b.T,
    "tree_combine_stacked": lambda s, c: c @ s,
}


def run(prob, w_star) -> dict:
    h = run_federated(prob, "fedosaa_scaffold",
                      AlgoHParams(eta=1.0, local_epochs=10), ROUNDS,
                      w_star=w_star, channel="fp32")
    rel = np.asarray(h.rel_error)
    return dict(rounds=len(rel), final=float(rel[-1]), least=float(rel.min()),
                loss=float(h.loss[-1]))


def main() -> None:
    jax.config.update("jax_enable_x64", True)
    X, y = make_binary_classification("covtype", n=20_000, seed=0)
    prob = make_logreg_problem(partition(X, y, 20, "iid", seed=0), 1e-3,
                               dtype=jnp.float64)
    w_star = solve_reference(prob, iters=100)
    out = {"as_is": run(prob, w_star)}
    saved = {name: getattr(tm, name) for name in F64_HELPERS}
    try:
        for name, fn in F64_HELPERS.items():
            setattr(tm, name, fn)
        out["f64_helpers"] = run(prob, w_star)
    finally:
        for name, fn in saved.items():
            setattr(tm, name, fn)
    rows = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                       / "results" / "ext_compression.json").read_text())
    committed = next(r for r in rows
                     if r["name"] == "ext_compression/fp32/fedosaa_scaffold")
    out["committed"] = dict(rounds=committed["rounds"],
                            final=committed["derived"],
                            least=min(committed["rel_error_curve"]),
                            loss=committed["final_loss"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
