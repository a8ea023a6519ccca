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


def make_mnist_like(
    n: int = 10_000, d: int = 784, num_classes: int = 10, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic 10-class 'MNIST' for the App. D.5 NN experiment: Gaussian
    class prototypes in a low-dim manifold embedded in d dims + pixel noise.
    Returns (X [n, d] float32 in (0, 1), y [n] int32)."""
    rng = np.random.default_rng(seed)
    latent_dim = 32
    protos = rng.standard_normal((num_classes, latent_dim)).astype(np.float32) * 3.0
    embed = rng.standard_normal((latent_dim, d)).astype(np.float32) / np.sqrt(latent_dim)
    y = rng.integers(0, num_classes, n)
    z = protos[y] + rng.standard_normal((n, latent_dim)).astype(np.float32)
    X = z @ embed + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    # squash to [0,1] like pixel intensities
    X = 1.0 / (1.0 + np.exp(-X))
    return X.astype(np.float32), y.astype(np.int32)


def make_lm_tokens(
    n_docs: int, seq_len: int, vocab: int, seed: int = 0
) -> np.ndarray:
    """Synthetic token stream with Zipfian unigram + Markov bigram structure
    (prompts for the LM serving path, documents for federated LM
    training). Returns [n_docs, seq_len] int32."""
    rng = np.random.default_rng(seed)
    # zipf over a capped vocab for speed
    v_eff = min(vocab, 32_768)
    ranks = np.arange(1, v_eff + 1)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(v_eff, size=(n_docs, seq_len), p=p)
    # light Markov smoothing: with prob .3 repeat previous token's neighborhood
    repeat = rng.random((n_docs, seq_len)) < 0.3
    shifted = np.roll(toks, 1, axis=1)
    toks = np.where(repeat, (shifted + rng.integers(0, 17, toks.shape)) % v_eff, toks)
    return toks.astype(np.int32)
