"""The PyTorch port's package rules: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU on their own, and
its data pipeline gives the reference's arrays bit for bit."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro_torch.core import AlgoHParams, run_federated
from repro_torch.core import convert
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the port's own files: its package and its smoke script
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    src = str(PORT.parent)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": os.pathsep.join([src, str(ROOT)])})
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(MODULES) > 20


def test_sources_name_no_jax_and_no_reference_package():
    assert (ROOT / "chip_smoke.py") in PORT_FILES
    for p in PORT_FILES:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (p, line)
            assert not s.startswith(("from repro.", "import repro.",
                                     "from repro import")), (p, line)
            assert s != "import repro", (p, line)


def test_entry_points_default_to_the_card():
    """Without a card, an entry point called without ``device=`` raises;
    it never moves to the CPU on its own."""
    X, y = make_binary_classification("synthetic_small", n=200, seed=0)
    clients = partition(X, y, 4, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64, device="cpu")
    hp = AlgoHParams(local_epochs=2)
    if torch.cuda.is_available():
        # the data lie on the CPU, the entry point asks for the card
        with pytest.raises(ValueError, match="build it with device"):
            run_federated(prob, "fedosaa_svrg", hp, 1)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federated(prob, "fedosaa_svrg", hp, 1)
    for build in (lambda: partition(X, y, 4, "iid", seed=0),
                  lambda: make_logreg_problem(clients, 1e-3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    h = run_federated(prob, "fedosaa_svrg", hp, 1, device="cpu")
    assert np.isfinite(h.loss).all()


@pytest.mark.parametrize("name,n", [("covtype", 1234), ("w8a", 500),
                                    ("synthetic_small", 300)])
def test_generator_is_bit_identical(name, n):
    a = make_binary_classification(name, n=n, seed=3)
    b = jax_make(name, n=n, seed=3)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("scheme", ["iid", "imbalance", "label_skew"])
def test_partition_is_bit_identical(scheme):
    X, y = make_binary_classification("covtype", n=1003, seed=1)
    ours = partition(X, y, 7, scheme, seed=2, device="cpu")
    ref = jax_partition(X, y, 7, scheme, seed=2)
    for field in ("x", "y", "mask", "weight"):
        a = getattr(ours, field).numpy()
        b = np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # and through convert, from the reference's arrays
    conv = convert.stacked_clients(ref.x, ref.y, ref.mask, ref.weight,
                                   device="cpu")
    for field in ("x", "y", "mask", "weight"):
        assert torch.equal(getattr(conv, field), getattr(ours, field)), field
