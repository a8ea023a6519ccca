"""Dataset generation (counterpart of repro/data/synthetic.py).

A copy of the reference's numpy generator, so both packages see the same
X and y from the same seed, bit for bit (pinned in
tests/test_torch_hygiene.py). The LIBSVM datasets the paper uses (covtype:
N=581,012 d=54; w8a: N=49,749 d=300) are replaced by synthetic generators
that match their dimension, class balance and feature correlation. If the
real files are present under $REPRO_DATA_DIR (libsvm text format), they are
loaded instead.
"""
from __future__ import annotations

import os

import numpy as np

DATASETS = {
    # name: (default N for experiments, d, positive fraction, margin scale)
    "covtype": (58_100, 54, 0.49, 1.0),    # paper uses N=581,012; 10% default here
    "w8a": (49_749, 300, 0.03, 1.0),
    "synthetic_small": (4_000, 40, 0.5, 1.0),
}


def _load_libsvm(path: str, d: int):
    xs, ys = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            y = float(parts[0])
            ys.append(1.0 if y > 0 else -1.0)
            row = np.zeros(d, np.float32)
            for tok in parts[1:]:
                i, v = tok.split(":")
                row[int(i) - 1] = float(v)
            xs.append(row)
    return np.stack(xs), np.asarray(ys, np.float32)


def make_binary_classification(
    name: str = "covtype",
    n: int | None = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (X [N,d] float32, y [N] in {−1,+1})."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}")
    n_default, d, pos_frac, scale = DATASETS[name]
    n = n or n_default

    data_dir = os.environ.get("REPRO_DATA_DIR", "")
    real = os.path.join(data_dir, name) if data_dir else ""
    if real and os.path.exists(real):
        X, y = _load_libsvm(real, d)
        return X[:n], y[:n]

    rng = np.random.default_rng(seed)
    # correlated features with decaying spectrum — mimics real tabular data
    # and yields an ill-conditioned Hessian like covtype's
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(d))).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    latent = rng.standard_normal((n, d)).astype(np.float32)
    X = (latent * spectrum) @ basis.T * scale
    # ground-truth separator + label noise, then rebalance to pos_frac
    w_true = rng.standard_normal(d).astype(np.float32)
    logits = X @ w_true / np.sqrt(d)
    thresh = np.quantile(logits, 1.0 - pos_frac)
    y = np.where(logits > thresh, 1.0, -1.0).astype(np.float32)
    # 2% label noise so the problem is not separable (keeps w* finite)
    flip = rng.random(n) < 0.02
    y[flip] = -y[flip]
    return X, y
