"""FedOSAA-SCAFFOLD under cohorts, the JAX reference against the port, on
the CPU: the paper-scale configuration of chip_smoke.py's phase 4d (synthetic
covtype n=581,012, K=100 iid, gamma=1e-3, eta=1, L=10, float64, the identity
wire, a cohort of C=10), 10 rounds.

The reference runs its vmap cohort rounds with float64 tree_math helpers
patched in (as the port's parity tests patch them) and its tree paths. The
port runs the same rounds fed the reference's cohort indices (its
``_sample_cohort`` on each round's key). Printed, as one JSON object: both
runs' rel-error and loss curves (and the reference's worst AA Gram
condition number a round), and for every round the distance
‖Δw‖/‖w‖ of one port round from the reference's state to the reference's
next state (‖Δw‖ where that state is w = 0), with the first round that
parts by more than 1e-7.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_cohort_scaffold.py
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.utils.tree_math as tm
from repro.core import AlgoHParams as RefHP
from repro.core import algorithms as ref_algos
from repro.core import init_state as ref_init_state
from repro.core import make_round_fn as ref_make_round_fn
from repro.data import make_binary_classification, partition
from repro.models.logreg import make_logreg_problem as ref_problem
from repro_torch.core import AlgoHParams, convert, make_round_fn
from repro_torch.core import solve_reference
from repro_torch.core.algorithms import COHORT
from repro_torch.models.logreg import make_logreg_problem

N, K, C, L, ETA, GAMMA, ROUNDS = 581_012, 100, 10, 10, 1.0, 1e-3, 10
ALGO = "fedosaa_scaffold"
F64_HELPERS = {
    "tree_dot": lambda a, b: jnp.sum(a * b),
    "tree_vdot_stacked": lambda s, v: s @ v,
    "tree_gram": lambda a, b: a @ b.T,
    "tree_combine_stacked": lambda s, c: c @ s,
}
PART = 1e-7


def ref_cohort(jp, rng) -> torch.Tensor:
    """The reference's cohort of the round keyed by ``rng``."""
    _, part_rng, _ = jax.random.split(rng, 3)
    idx, _ = ref_algos._sample_cohort(jp.clients.weight, C, part_rng)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def port_state(st):
    return convert.server_state(st.params, st.t, st.comm, c=st.c, c_k=st.c_k,
                                device="cpu")


def main() -> None:
    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    jax.config.update("jax_enable_x64", True)
    for name, fn in F64_HELPERS.items():
        setattr(tm, name, fn)
    X, y = make_binary_classification("covtype", n=N, seed=0)
    jc = partition(X, y, K, "iid", seed=0)
    jp = ref_problem(jc, GAMMA, dtype=jnp.float64)
    pc = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight, device="cpu")
    pp = make_logreg_problem(pc, GAMMA, dtype=torch.float64, device="cpu")
    w_star = solve_reference(pp, iters=100)
    ws_norm = float(torch.linalg.vector_norm(w_star))

    jhp = RefHP(eta=ETA, local_epochs=L, cohort_size=C, aa_impl="tree",
                local_impl="tree")
    rf = jax.jit(ref_make_round_fn(ALGO, jp, jhp, None))
    ours = make_round_fn(ALGO, pp, AlgoHParams(eta=ETA, local_epochs=L,
                                               cohort_size=C), device="cpu")

    def rel(w) -> float:
        w = w if torch.is_tensor(w) else torch.from_numpy(np.array(w))
        return float(torch.linalg.vector_norm(w - w_star)) / ws_norm

    ref_st = ref_init_state(jp, jax.random.PRNGKey(0), jhp, None, ALGO)
    st = port_state(ref_st)
    out = {"ref": {"rel_error": [], "loss": [], "gram_cond_max": []},
           "port": {"rel_error": [], "loss": []},
           "one_round": [], "cohorts": []}
    for _ in range(ROUNDS):
        idx = ref_cohort(jp, ref_st.rng)
        out["cohorts"].append(idx.tolist())
        # one port round from the reference's state, fed its cohort
        start = port_state(ref_st)
        one, _ = ours(start, {COHORT: idx})
        ref_st, ref_m = rf(ref_st)
        ref_w = np.asarray(ref_st.params)
        # ‖Δw‖/‖w‖, or ‖Δw‖ where the round leaves w at 0
        err = float(np.linalg.norm(one.params.numpy() - ref_w))
        norm = float(np.linalg.norm(ref_w))
        out["one_round"].append(err / norm if norm > 0 else err)
        out["ref"]["rel_error"].append(rel(ref_w))
        out["ref"]["loss"].append(float(ref_m.loss))
        out["ref"]["gram_cond_max"].append(float(ref_m.gram_cond_max))
        # the port's own run, fed the same cohort
        st, m = ours(st, {COHORT: idx})
        out["port"]["rel_error"].append(rel(st.params))
        out["port"]["loss"].append(float(m.loss))
    parted = [t for t, e in enumerate(out["one_round"]) if e > PART]
    out["first_round_parting"] = parted[0] if parted else None
    out["curve_rel_diff"] = [abs(a - b) / max(abs(b), 1e-300) for a, b in zip(
        out["port"]["rel_error"], out["ref"]["rel_error"])]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
