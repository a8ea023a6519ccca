"""The paper's Theorem-1 contract on the port: the two tests of
tests/test_convergence_contract.py, run on the port's round (its
run_federated and solve_reference) over the same seeded quadratic in f32.

The quadratic is built as a plain port FLProblem from the same loss, with
no linear design, so the port runs its autodiff ("tree") local path, as
the reference does on it; the AA step takes the default kernel path (its
plain version on the CPU). The int8 test runs on the port's own draws.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (AlgoHParams, FLProblem, StackedClients,
                              run_federated, solve_reference)

from torch_threads import one_torch_thread  # noqa: F401

K, N_PER, D = 4, 256, 8
GAMMA = 1e-2
ETA = 0.2
LOCAL_EPOCHS = 5
SEED = 0
# the client-Hessian scale skew of the reference's contract (see there)
SCALE_HET = 0.2


def _make_quadratic_problem():
    """K heterogeneous least-squares clients: f_k(w) = ½·mean_i (x_i'w −
    y_i)² + ½γ‖w‖², the reference's data drawn by the same numpy calls."""
    rng = np.random.default_rng(SEED)
    w_true = rng.standard_normal(D)
    xs, ys = [], []
    for k in range(K):
        X = rng.standard_normal((N_PER, D)) * (1.0 + SCALE_HET * k / K)
        y = X @ (w_true + 0.3 * rng.standard_normal(D)) + 0.1 * rng.standard_normal(N_PER)
        xs.append(X)
        ys.append(y)
    clients = StackedClients(
        x=torch.tensor(np.stack(xs), dtype=torch.float32),
        y=torch.tensor(np.stack(ys), dtype=torch.float32),
        mask=torch.ones((K, N_PER), dtype=torch.float32),
        weight=torch.full((K,), 1.0 / K, dtype=torch.float32),
    )

    def loss(w, batch):
        r = batch.x @ w - batch.y
        denom = torch.clamp(batch.mask.sum(), min=1.0)
        return (0.5 * (batch.mask * r * r).sum() / denom
                + 0.5 * GAMMA * (w * w).sum())

    problem = FLProblem(
        loss=loss,
        init=lambda generator=None: torch.zeros(D, dtype=torch.float32),
        clients=clients,
    )
    A = sum((np.stack(xs)[k].T @ np.stack(xs)[k] / N_PER) / K for k in range(K))
    A += GAMMA * np.eye(D)
    evals = np.linalg.eigvalsh(A)
    return problem, float(evals[0]), float(evals[-1])


@pytest.fixture(scope="module")
def quadratic():
    problem, mu, lip = _make_quadratic_problem()
    wstar = solve_reference(problem, iters=20)
    return problem, wstar, mu, lip


def _fitted_rate(rel_error, floor=3e-5):
    """Per-round linear contraction factor ρ and the log-linear fit's
    largest residual, over the rounds before the f32 floor."""
    e = np.asarray(rel_error, np.float64)
    keep = e > floor
    n = int(np.argmin(keep)) if not keep.all() else len(e)
    e = e[:n]
    assert len(e) >= 3, f"trace floored too fast to fit a rate: {rel_error}"
    t = np.arange(len(e))
    slope, intercept = np.polyfit(t, np.log(e), 1)
    resid = np.log(e) - (slope * t + intercept)
    return float(np.exp(slope)), float(np.max(np.abs(resid)))


class TestTheorem1Contract:
    def test_fedosaa_rate_beats_fedsvrg_rate(self, quadratic):
        problem, wstar, mu, lip = quadratic
        hp = AlgoHParams(eta=ETA, local_epochs=LOCAL_EPOCHS)
        h_svrg = run_federated(problem, "fedsvrg", hp, 25, w_star=wstar,
                               device="cpu")
        h_osaa = run_federated(problem, "fedosaa_svrg", hp, 25, w_star=wstar,
                               device="cpu")
        rho_svrg, fit_svrg = _fitted_rate(h_svrg.rel_error)
        rho_osaa, fit_osaa = _fitted_rate(h_osaa.rel_error)

        # 1. both contract linearly, FedSVRG with a tight log-linear fit
        assert rho_svrg < 1.0 and rho_osaa < 1.0
        assert fit_svrg < 0.5, (rho_svrg, fit_svrg)
        # 2. the Theorem-1 ordering: FedOSAA's rate at most half FedSVRG's
        assert rho_osaa < 0.5 * rho_svrg, (rho_osaa, rho_svrg)
        # 3. below the first-order rate (1 − ημ)^L, which FedSVRG cannot
        #    beat by more than fit noise
        first_order_rate = (1.0 - ETA * mu) ** LOCAL_EPOCHS
        assert rho_osaa < first_order_rate, (rho_osaa, first_order_rate)
        assert rho_svrg > 0.5 * first_order_rate, (rho_svrg, first_order_rate)

    def test_contract_survives_int8_wire(self, quadratic):
        """Rounds to rel-error 1e-4 on the int8 wire: FedOSAA-SVRG at least
        two rounds before FedSVRG."""
        problem, wstar, mu, lip = quadratic
        hp = AlgoHParams(eta=ETA, local_epochs=LOCAL_EPOCHS)
        target = 1e-4

        def rounds_to(h):
            hit = np.nonzero(np.asarray(h.rel_error) < target)[0]
            assert hit.size, f"never reached {target}: {h.rel_error}"
            return int(hit[0]) + 1

        h_svrg = run_federated(problem, "fedsvrg", hp, 25, w_star=wstar,
                               channel="int8", seed=SEED,
                               stop_rel_error=0.1 * target, device="cpu")
        h_osaa = run_federated(problem, "fedosaa_svrg", hp, 25, w_star=wstar,
                               channel="int8", seed=SEED,
                               stop_rel_error=0.1 * target, device="cpu")
        assert rounds_to(h_osaa) <= rounds_to(h_svrg) - 2, (
            h_osaa.rel_error, h_svrg.rel_error)
