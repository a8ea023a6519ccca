"""Quickstart on the PyTorch/CUDA port: FedOSAA vs FedSVRG on federated
logistic regression (the port's counterpart of examples/quickstart.py).

  PYTHONPATH=src python examples/quickstart_torch.py               # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

One Anderson-acceleration step after the SVRG local epochs turns a
first-order method into a Newton-GMRES-class method, at the same
communication cost. ``--n`` and ``--rounds`` default to the reference
example's setup (10,000 samples, 15 rounds); ``--dtype float64`` runs the
paper's deep rel-error regime.
"""
import argparse

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import AlgoHParams, run_federated, solve_reference
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem


def main(argv=None) -> dict:
    """Print the two relative-error curves; return their Histories."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000, help="samples")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # federated setup: 10 clients, IID split of a covtype-like dataset
    X, y = make_binary_classification("covtype", n=args.n, seed=0)
    clients = partition(X, y, num_clients=10, scheme="iid", device=args.device)
    problem = make_logreg_problem(clients, gamma=1e-3,
                                  dtype=getattr(torch, args.dtype),
                                  device=args.device)
    # Newton-CG to the dtype's floor: in f32 it never meets its 1e-12 stop,
    # and steps past the first tens only move w* within roundoff
    w_star = solve_reference(problem, iters=100)   # reference minimizer

    hp = AlgoHParams(eta=1.0, local_epochs=10)  # paper defaults
    print(f"{'round':>5} | {'FedSVRG':>12} | {'FedOSAA-SVRG':>12}   (relative error)")
    h_svrg = run_federated(problem, "fedsvrg", hp, args.rounds, w_star=w_star,
                           device=args.device)
    h_osaa = run_federated(problem, "fedosaa_svrg", hp, args.rounds,
                           w_star=w_star, device=args.device)
    for t in range(len(h_svrg.rounds)):
        print(f"{t:5d} | {h_svrg.rel_error[t]:12.3e} | {h_osaa.rel_error[t]:12.3e}")
    print(f"\nSame communication (2d floats/round), same local gradient count "
          f"(L+1={hp.local_epochs + 1}):")
    print(f"  FedSVRG      final rel-err: {h_svrg.rel_error[-1]:.3e}")
    print(f"  FedOSAA-SVRG final rel-err: {h_osaa.rel_error[-1]:.3e}")
    return {"fedsvrg": h_svrg, "fedosaa_svrg": h_osaa}


if __name__ == "__main__":
    main()
