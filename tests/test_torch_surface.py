"""The last public functions of the JAX package that the port mirrors, and
its exports, against the reference on the CPU:

* ``core/anderson.py::aa_mixing_step`` (the paper's mixing form, Eq. 2–3)
  against the reference's on the same f64 inputs, with the reference's AA
  contractions accumulating in f64 as in tests/test_torch_anderson.py
  (1e-10 of the largest magnitude), and against the port's own
  ``multisecant_update`` as tests/test_anderson.py holds the reference's
  (2e-3; Σα = 1 to 1e-5);
* ``core/algorithms.py::fused_local_eligible`` equal to the reference's for
  every algorithm on the logreg, linreg, MLP and LM problems;
* ``data/partition.py::heterogeneity_score`` and
  ``models/logreg.py::logreg_accuracy`` equal to the reference's,
  ``logreg_condition_number`` within rel 1e-10 in f64;
* every name a package ``__init__`` of the reference exports is exported
  by the port's counterpart, but for the JAX-only names of ``JAX_ONLY``.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.configs import get_arch as jax_get_arch
from repro.core.algorithms import ALGORITHMS as JAX_ALGORITHMS
from repro.core.algorithms import fused_local_eligible as jax_eligible
from repro.core.anderson import AAConfig as JaxAAConfig
from repro.core.anderson import aa_mixing_step as jax_mixing
from repro.core.lm import make_lm_clients as jax_make_lm_clients
from repro.core.lm import make_lm_problem as jax_make_lm_problem
from repro.data import heterogeneity_score as jax_heterogeneity
from repro.data import make_binary_classification as jax_make
from repro.data import make_mnist_like as jax_make_mnist
from repro.data import partition as jax_partition
from repro.models.decoder import build_model as jax_build_model
from repro.models.linreg import make_linreg_problem as jax_make_linreg
from repro.models.logreg import logreg_accuracy as jax_accuracy
from repro.models.logreg import logreg_condition_number as jax_condition
from repro.models.logreg import make_logreg_problem as jax_make_logreg
from repro.models.mlp import make_mlp_problem as jax_make_mlp
from repro_torch.configs import get_arch
from repro_torch.core import (ALGORITHMS, AAConfig, aa_mixing_step,
                              fused_local_eligible, multisecant_update,
                              trajectory_to_sy)
from repro_torch.core.lm import make_lm_clients, make_lm_problem
from repro_torch.data import (heterogeneity_score, make_binary_classification,
                              make_lm_tokens, make_mnist_like, partition)
from repro_torch.models.decoder import build_model
from repro_torch.models.linreg import make_linreg_problem
from repro_torch.models.logreg import (logreg_accuracy, logreg_condition_number,
                                       make_logreg_problem)
from repro_torch.models.mlp import make_mlp_problem

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

#: names of the reference's package exports that have no port counterpart,
#: each for a reason of JAX's own
JAX_ONLY = {
    "kernels/local_update": {
        # the Pallas kernel itself: the port's is csrc/trajectory.cu,
        # reached through fused_trajectory
        "trajectory_pallas",
        # the reference's Pallas/interpret/ref switch; the port's wrappers
        # choose by the tensors' device
        "FUSED_IMPLS",
    },
    # pytree helpers: the port's parameters are one flat tensor, and
    # utils/tree_math.py keeps only the contractions on it
    "utils": {"tree_add", "tree_cast", "tree_dynamic_update", "tree_random_like",
              "tree_scale", "tree_size", "tree_stack", "tree_sub",
              "tree_unstack_index", "tree_where", "tree_zeros_like"},
}


@pytest.fixture
def x64():
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


@pytest.fixture
def ref_f64(x64, monkeypatch):
    """The reference's AA contractions accumulating in the leaves' dtype."""
    monkeypatch.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
    monkeypatch.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
    monkeypatch.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
    monkeypatch.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)


def random_walk(d, L, seed, dtype=np.float64):
    """tests/test_anderson.py's random walk on a quadratic: iterates w
    [L+1, d] and their gradients r = A w − b."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    A = (Q * np.geomspace(1.0, 50.0, d)) @ Q.T
    b = rng.standard_normal(d)
    ws = np.cumsum(rng.standard_normal((L + 1, d)), axis=0) * 0.1
    return ws.astype(dtype), (ws @ A.T - b).astype(dtype)


def assert_close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("cfg", [dict(), dict(tikhonov=0.0),
                                 dict(filter_rtol=1e-8)], ids=str)
def test_aa_mixing_step_matches_reference(ref_f64, cfg):
    ws, rs = random_walk(10, 5, seed=11)
    w_hist, r_hist = ws[::-1].copy(), -0.05 * rs[::-1]
    w, alpha = aa_mixing_step(torch.from_numpy(w_hist), torch.from_numpy(r_hist),
                              AAConfig(**cfg))
    ref_w, ref_alpha = jax_mixing(jnp.asarray(w_hist), jnp.asarray(r_hist),
                                  JaxAAConfig(**cfg))
    assert w.shape == (10,) and alpha.shape == (6,) and w.dtype == torch.float64
    assert_close(w, ref_w, 1e-10)
    assert_close(alpha, ref_alpha, 1e-10)


@pytest.mark.parametrize("impl", ["tree", "kernel"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_aa_mixing_step_equals_multisecant(impl, dtype):
    """Eq. 2–3 (the mixing form) equals Eq. 4–5 (the multisecant form) on
    the same history, as tests/test_anderson.py::TestMixingEquivalence
    holds the reference's: 2e-3, and the weights sum to one."""
    eta = 0.05
    ws, rs = (torch.from_numpy(a) for a in random_walk(10, 5, 11, dtype))
    # newest first; the residual of the map w − η grad is −η grad
    w_mix, alpha = aa_mixing_step(ws.flip(0), -eta * rs.flip(0),
                                  AAConfig(tikhonov=0.0))
    s, y = trajectory_to_sy(ws, rs)
    w_ms, _ = multisecant_update(ws[-1], rs[-1], s[None], y[None], eta,
                                 AAConfig(tikhonov=0.0), impl=impl)
    np.testing.assert_allclose(w_mix.numpy(), w_ms[0].numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(float(alpha.sum()), 1.0, rtol=1e-5)


def _problems():
    """(name, reference problem, port problem) for each model family."""
    X, y = make_binary_classification("synthetic_small", n=200, seed=0)
    jc, pc = jax_partition(X, y, 4, "iid"), partition(X, y, 4, "iid", device="cpu")
    Xm, ym = make_mnist_like(n=64, seed=0)
    jm, pm = (jax_partition(Xm, ym.astype(np.float32), 2, "iid"),
              partition(Xm, ym.astype(np.float32), 2, "iid", device="cpu"))
    jcfg, cfg = jax_get_arch("smollm-135m").reduced(), get_arch("smollm-135m").reduced()
    toks = make_lm_tokens(4, 16, cfg.vocab_size)
    return [
        ("logreg", jax_make_logreg(jc), make_logreg_problem(pc, device="cpu")),
        ("linreg", jax_make_linreg(jc), make_linreg_problem(pc, device="cpu")),
        ("mlp", jax_make_mlp(jm), make_mlp_problem(pm, device="cpu")),
        ("lm", jax_make_lm_problem(jax_build_model(jcfg), jax_make_lm_clients(toks, 2)),
         make_lm_problem(build_model(cfg, device="cpu"),
                         make_lm_clients(toks, 2, device="cpu"))),
    ]


def test_fused_local_eligible_matches_reference():
    assert ALGORITHMS == JAX_ALGORITHMS
    eligible = {}
    for name, jp, pp in _problems():
        got = {a: fused_local_eligible(pp, a) for a in (None, *ALGORITHMS)}
        want = {a: jax_eligible(jp, a) for a in (None, *ALGORITHMS)}
        assert got == want, name
        eligible[name] = got[None]
        # parameters that are not one flat [d] vector
        if name in ("logreg", "linreg"):
            stacked = jnp.zeros((3, jp.clients.x.shape[-1]))
            assert not jax_eligible(jp, "fedosaa_svrg", stacked)
            assert not fused_local_eligible(pp, "fedosaa_svrg",
                                            torch.zeros(tuple(stacked.shape)))
    assert eligible == {"logreg": True, "linreg": True, "mlp": False, "lm": False}


@pytest.mark.parametrize("scheme", ["iid", "imbalance", "label_skew"])
def test_heterogeneity_score_equals_reference(scheme):
    X, y = jax_make("covtype", n=2000, seed=0)
    want = jax_heterogeneity(jax_partition(X, y, 10, scheme))
    got = heterogeneity_score(partition(X, y, 10, scheme, device="cpu"))
    assert isinstance(got, float) and got == want


@pytest.mark.parametrize("n", [777, 2000])
@pytest.mark.parametrize("f64", [False, True])
def test_logreg_accuracy_and_condition_number_match_reference(f64, n, x64):
    jax.config.update("jax_enable_x64", f64)
    dtype = np.float64 if f64 else np.float32
    X, y = jax_make("covtype", n=n, seed=0)
    w = np.random.default_rng(5).standard_normal(X.shape[1]).astype(dtype) * 0.3
    want = jax_accuracy(jnp.asarray(w), jnp.asarray(X), jnp.asarray(y))
    got = logreg_accuracy(torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y))
    assert isinstance(got, float) and got == want
    if f64:
        jc = jax_partition(X, y, 10, "iid")
        want = jax_condition(jc, jnp.asarray(w), 1e-3)
        got = logreg_condition_number(partition(X, y, 10, "iid", device="cpu"),
                                      torch.from_numpy(w), 1e-3)
        assert abs(got - want) <= 1e-10 * abs(want), (got, want)


def _exports(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names


def test_every_reference_export_has_a_port_export():
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    inits = sorted(ref.rglob("__init__.py"))
    assert len(inits) == 11
    for init in inits:
        pkg = init.parent.relative_to(ref).as_posix()
        mine = port / init.relative_to(ref)
        assert mine.exists(), pkg
        missing = _exports(init) - _exports(mine) - JAX_ONLY.get(pkg, set())
        assert not missing, (pkg, sorted(missing))
        # a JAX-only name is really absent from the port
        assert not JAX_ONLY.get(pkg, set()) & _exports(mine), pkg
