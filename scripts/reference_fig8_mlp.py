"""Fig. 8's quick configuration (benchmarks/fig8_nn.py: make_mnist_like
n=4,000, K=10 iid, eta 0.1, L=10, 15 rounds) on the JAX reference, from a
numpy He init (seed 0: for each layer normal(din, dout) * sqrt(2/din) in
float32, zero biases), so that the port can start from the same weights
(chip_smoke.py phase 6b (f) pins these numbers). Prints, per depth and
algorithm, the final loss and the training accuracy.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fig8_mlp.py
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from repro.core import AlgoHParams, run_federated
from repro.data import make_mnist_like, partition
from repro.models.mlp import make_mlp_problem, mlp_accuracy

N, K, ETA, L, ROUNDS = 4_000, 10, 0.1, 10, 15


def he_init(depth: int, seed: int = 0, in_dim: int = 784, hidden: int = 256,
            classes: int = 10) -> list[np.ndarray]:
    """[w0, b0, w1, b1, ...] (the layer order of repro_torch/models/mlp.py)."""
    rng = np.random.default_rng(seed)
    dims = [in_dim] + [hidden] * depth + [classes]
    out = []
    for din, dout in zip(dims[:-1], dims[1:]):
        out += [rng.standard_normal((din, dout), dtype=np.float32)
                * np.float32(np.sqrt(2.0 / din)), np.zeros(dout, np.float32)]
    return out


def main() -> None:
    X, y = make_mnist_like(n=N, seed=0)
    clients = partition(X, y.astype(np.float32), num_clients=K, scheme="iid")
    for depth in (1, 3):
        prob = make_mlp_problem(clients, hidden_layers=depth)
        arrays = he_init(depth)
        w0 = {f"{kind}{i // 2}": jnp.asarray(a)
              for i, (kind, a) in enumerate(zip("wb" * (depth + 1), arrays))}
        for algo in ("fedsvrg", "fedosaa_svrg"):
            h = run_federated(prob, algo, AlgoHParams(eta=ETA, local_epochs=L),
                              ROUNDS, w0=w0)
            acc = mlp_accuracy(prob, h.final_params, X, y)
            print(f"mlp{depth} {algo}: final loss {float(h.loss[-1])!r}, "
                  f"accuracy {acc!r}")


if __name__ == "__main__":
    main()
