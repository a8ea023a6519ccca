"""Full algorithm shoot-out (paper Figure 2) on the PyTorch/CUDA port:
FedOSAA vs first- and second-order FL methods under IID / imbalance /
label-skew partitions (the port's counterpart of
examples/fl_logreg_comparison.py, with its flags and ``--device``).

  PYTHONPATH=src python examples/fl_logreg_comparison_torch.py [--scheme label_skew]
  PYTHONPATH=src python examples/fl_logreg_comparison_torch.py --device cpu
"""
import argparse

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import AlgoHParams, run_federated, solve_reference
from repro_torch.data import heterogeneity_score, make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem

ALGOS = ["fedavg", "fedsvrg", "scaffold", "lbfgs", "giant",
         "newton_gmres", "fedosaa_svrg", "fedosaa_scaffold"]


def main(argv=None) -> dict:
    """Print each algorithm's summary line; return the Histories by name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="iid",
                    choices=["iid", "imbalance", "label_skew"])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients active per round (<1.0 samples "
                         "a max(1, round(pK))-client cohort each round)")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="explicit per-round cohort size C (overrides "
                         "--participation; non-sampled clients' state stays "
                         "frozen); 0 = derive from --participation")
    ap.add_argument("--comm-codec", default="identity",
                    help="wire-compression channel (repro_torch/comm): "
                         "identity | bf16 | int8 | topk[:ratio] ...")
    ap.add_argument("--round-chunk", type=int, default=0,
                    help="run this many rounds per chunk of the engine "
                         "(core/engine.py: one CUDA graph on the card); "
                         "0 = per-round loop")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    X, y = make_binary_classification("covtype", n=10_000, seed=0)
    clients = partition(X, y, num_clients=10, scheme=args.scheme,
                        device=args.device)
    print(f"scheme={args.scheme}  heterogeneity={heterogeneity_score(clients):.3f}")
    problem = make_logreg_problem(clients, gamma=1e-3, device=args.device)
    w_star = solve_reference(problem, iters=100)  # as quickstart_torch.py

    eta = 0.5 if args.scheme == "label_skew" else 1.0
    hp = AlgoHParams(eta=eta, local_epochs=10,
                     participation=args.participation,
                     cohort_size=args.cohort_size or None)
    out = {}
    for algo in ALGOS:
        h = run_federated(problem, algo, hp, args.rounds, w_star=w_star,
                          device=args.device, channel=args.comm_codec,
                          chunk=args.round_chunk or None)
        print(h.summary())
        out[algo] = h
    return out


if __name__ == "__main__":
    main()
