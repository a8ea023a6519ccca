"""Client partitioners (counterpart of repro/data/partition.py).

* iid        — random equal split (extra data dropped, paper D.2)
* imbalance  — power-law sizes: largest client 50% of data, smallest 0.2%
* label_skew — near-equal sizes, each client dominated by one label

The split is numpy, identical to the reference's; the stacking goes
through the port's own ``core.problem.stack_client_arrays``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.problem import StackedClients, stack_client_arrays

PARTITIONERS = ("iid", "imbalance", "label_skew")


def partition(
    X: np.ndarray,
    y: np.ndarray,
    num_clients: int,
    scheme: str = "iid",
    seed: int = 0,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> StackedClients:
    if scheme not in PARTITIONERS:
        raise ValueError(f"unknown scheme {scheme!r}; choose from {PARTITIONERS}")
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]

    if scheme == "iid":
        n_k = n // num_clients
        xs = [X[k * n_k:(k + 1) * n_k] for k in range(num_clients)]
        ys = [y[k * n_k:(k + 1) * n_k] for k in range(num_clients)]

    elif scheme == "imbalance":
        # geometric interpolation from 50% down to 0.2% (paper §4), normalized
        if n < 2 * num_clients:
            raise ValueError(
                f"imbalance partition needs >= 2 samples per client: "
                f"n={n} < 2*num_clients={2 * num_clients}")
        fracs = np.geomspace(0.5, 0.002, num_clients)
        fracs = fracs / fracs.sum()
        counts = np.maximum((fracs * n).astype(int), 2)
        # the 2-sample floor can push the total past n; trim the excess from
        # the largest clients (never below 2)
        excess = int(counts.sum()) - n
        while excess > 0:
            k = int(np.argmax(counts))
            take = min(excess, int(counts[k]) - 2)
            counts[k] -= take
            excess -= take
        if excess < 0:
            # floor-rounding undershoot: the remainder goes to the largest client
            counts[int(np.argmax(counts))] -= excess
        edges = np.concatenate([[0], np.cumsum(counts)])
        xs = [X[edges[k]:edges[k + 1]] for k in range(num_clients)]
        ys = [y[edges[k]:edges[k + 1]] for k in range(num_clients)]

    else:  # label_skew: sort by label, deal contiguous label blocks to clients
        order = np.argsort(y, kind="stable")
        X, y = X[order], y[order]
        n_k = n // num_clients
        xs = [X[k * n_k:(k + 1) * n_k] for k in range(num_clients)]
        ys = [y[k * n_k:(k + 1) * n_k] for k in range(num_clients)]

    return stack_client_arrays(xs, ys, device=device)
