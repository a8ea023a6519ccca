"""The reference's FL-round dry-run (repro/launch/dryrun.py::dryrun_fl_round)
of FedOSAA-SVRG, 2 rounds, on 512 emulated host devices, as it is (float32,
the committed row benchmarks/results/dryrun/fl_round__fedosaa_svrg__16x16.json)
and in float64 with float64 tree_math helpers patched in (the dtype the port
is held in, ROADMAP.md: the float32 AA step of this workload, at Gram
condition numbers 1e7-2e9, is roundoff-bound). Also the reference's vmap
round of the same float32 workload, whose second loss parts from the
sharded round's. Prints each run's loss curve, rel-error curve and the
last round's bytes: the numbers chip_smoke.py phase 6g (d) holds the
port's float64 run to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_dryrun_fl_f64.py
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.logreg as lr  # noqa: E402
import repro.utils.tree_math as tm  # noqa: E402
from repro.core import AlgoHParams, init_state, make_round_fn  # noqa: E402
from repro.data import make_binary_classification, partition  # noqa: E402
from repro.launch.dryrun import dryrun_fl_round  # noqa: E402

ROUNDS = 2


def show(name: str, res: dict) -> None:
    print(f"{name}: loss_curve {res['loss_curve']} rel_error_curve "
          f"{res['rel_error_curve']} comm_bytes {res['comm_bytes']}", flush=True)


def vmap_losses(dtype) -> list:
    """The reference's vmap round (make_round_fn) of the same workload."""
    X, y = make_binary_classification("synthetic_small", n=2048, seed=0)
    prob = lr.make_logreg_problem(partition(X, y, num_clients=64, scheme="iid"),
                                  1e-3, dtype=dtype)
    hp = AlgoHParams(eta=0.5, local_epochs=3)
    state = init_state(prob, jax.random.PRNGKey(0), hp, None, "fedosaa_svrg")
    rf = jax.jit(make_round_fn("fedosaa_svrg", prob, hp, None))
    out = []
    for _ in range(ROUNDS):
        state, m = rf(state)
        out.append(float(m.loss))
    return out


def main() -> None:
    show("float32 (as committed)", dryrun_fl_round("fedosaa_svrg", rounds=ROUNDS))
    print(f"float32 vmap round: loss_curve {vmap_losses(jnp.float32)}", flush=True)
    jax.config.update("jax_enable_x64", True)
    tm.tree_dot = lambda a, b: jnp.sum(a * b)
    tm.tree_vdot_stacked = lambda s, v: s @ v
    tm.tree_gram = lambda a, b: a @ b.T
    tm.tree_combine_stacked = lambda s, c: c @ s
    problem = lr.make_logreg_problem
    lr.make_logreg_problem = lambda clients, gamma=1e-3: problem(
        clients, gamma, dtype=jnp.float64)
    show("float64, float64 helpers", dryrun_fl_round("fedosaa_svrg", rounds=ROUNDS))


if __name__ == "__main__":
    main()
