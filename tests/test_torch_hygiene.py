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

from torch_threads import one_torch_thread  # noqa: F401

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


def test_scans_cover_the_engine_and_obs():
    """The scans above and below walk the package by rglob: the engine, the
    obs/ package, the cohorts' client store and the robust/ package are in
    them."""
    new = {"repro_torch.core.engine", "repro_torch.obs",
           "repro_torch.obs.sinks", "repro_torch.obs.alarms",
           "repro_torch.obs.profiling", "repro_torch.core.client_store",
           "repro_torch.robust", "repro_torch.robust.faults",
           "repro_torch.robust.async_agg"}
    assert new <= set(MODULES)
    assert {PORT / "core" / "engine.py", PORT / "obs" / "profiling.py",
            PORT / "core" / "client_store.py", PORT / "robust" / "faults.py",
            PORT / "robust" / "async_agg.py"} <= set(PORT_FILES)


def test_scans_cover_checkpoint_and_fs_faults():
    """The checkpoint package and the storage fault harness are in the
    import and source scans."""
    new = {"repro_torch.checkpoint", "repro_torch.checkpoint.atomic",
           "repro_torch.checkpoint.sharded_ckpt",
           "repro_torch.checkpoint.checkpoint",
           "repro_torch.checkpoint.policy", "repro_torch.robust.fs_faults"}
    assert new <= set(MODULES)
    assert {PORT / "checkpoint" / f for f in (
        "__init__.py", "atomic.py", "sharded_ckpt.py", "checkpoint.py",
        "policy.py")} | {PORT / "robust" / "fs_faults.py"} <= set(PORT_FILES)


def test_scans_cover_the_sharded_runtime():
    """The distributed runtime is in the import and source scans."""
    assert "repro_torch.core.sharded" in MODULES
    assert PORT / "core" / "sharded.py" in PORT_FILES


def test_scans_cover_the_tensor_parallel_modules():
    """The sharding plan and the mesh are in the import and source scans."""
    assert {"repro_torch.sharding", "repro_torch.sharding.specs",
            "repro_torch.launch.mesh"} <= set(MODULES)
    assert {PORT / "sharding" / "specs.py", PORT / "launch" / "mesh.py"} <= set(PORT_FILES)


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
    # a cohort round too
    cohort = AlgoHParams(local_epochs=2, cohort_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federated(prob, "fedosaa_svrg", cohort, 1)
    h = run_federated(prob, "fedosaa_svrg", cohort, 1, device="cpu", chunk=1)
    assert np.isfinite(h.loss).all()
    # a faulted, gated round too
    from repro_torch.robust import AsyncConfig, FaultPlan
    kw = dict(faults=FaultPlan(drop_rate=0.3, stale_rate=0.3, dp_sigma=1e-3,
                               latency_scale=1.0),
              async_cfg=AsyncConfig(deadline=2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federated(prob, "fedosaa_svrg", hp, 1, **kw)
    h = run_federated(prob, "fedosaa_svrg", hp, 1, device="cpu", **kw)
    assert np.isfinite(h.loss).all() and np.isfinite(h.arrivals).all()


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


@pytest.mark.parametrize("n_docs,seq_len,vocab,seed", [(4, 2048, 32000, 0),
                                                       (3, 17, 1024, 5),
                                                       (2, 64, 50280, 1)])
def test_lm_tokens_are_bit_identical(n_docs, seq_len, vocab, seed):
    from repro.data.synthetic import make_lm_tokens as jax_make_lm_tokens
    from repro_torch.data import make_lm_tokens
    a = make_lm_tokens(n_docs, seq_len, vocab, seed=seed)
    b = jax_make_lm_tokens(n_docs, seq_len, vocab, seed=seed)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_arch_configs_equal_the_reference():
    """Each of the ten architectures, the benchmark input shapes, and the
    derived reduced and padded variants equal the reference's field for
    field (dataclasses.asdict)."""
    import dataclasses

    from repro.configs import ARCHS as jax_archs
    from repro.configs import INPUT_SHAPES as jax_shapes
    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch
    assert ARCHS == jax_archs and len(ARCHS) == 10
    assert ({k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jax_shapes.items()})
    for name in ARCHS:
        ours, ref = get_arch(name), jax_get_arch(name)
        for a, b in ((ours, ref), (ours.reduced(), ref.reduced()),
                     (ours.padded(16), ref.padded(16))):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert a.param_count() == b.param_count(), name
