"""The port's four examples (examples/*_torch.py) on the CPU at small sizes.

quickstart_torch.py (n=2000, f64, the reference's 15 rounds) against the
reference's functions run on the same setup, with its AA contractions
accumulating in f64 (tests/test_torch_anderson.py's patch): FedSVRG's
rel-error curve within rtol 1e-4 a round; FedOSAA-SVRG, a multi-round
run through a Gram solve at condition numbers of ~1e8 and more, by
ROADMAP's rule: its rounds to rel-error 1e-6 within one round of the
reference's and its final loss within rel 1e-10. The other three must
exit cleanly and print the reference's columns. Each example refuses to
run without a card unless given ``--device cpu``.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import run_federated as jax_run_federated
from repro.core import solve_reference as jax_solve_reference
from repro.data import heterogeneity_score as jax_heterogeneity
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_make_logreg

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
N, ROUNDS = 2000, 15


def example(name: str):
    """Import examples/<name>.py as a module (its main(argv) is the entry)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def columns(line: str) -> list:
    return re.findall(r"(\S+?)=", line)


def rounds_to(curve, target: float = 1e-6):
    hit = np.nonzero(np.asarray(curve) < target)[0]
    return int(hit[0]) + 1 if len(hit) else None


@pytest.fixture(scope="module")
def reference_quickstart():
    """The reference's quickstart setup at n=N in f64 (f64 contractions in
    its AA step): FedSVRG's and FedOSAA-SVRG's Histories."""
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
    mp.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
    mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
    mp.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
    try:
        X, y = jax_make("covtype", n=N, seed=0)
        problem = jax_make_logreg(jax_partition(X, y, num_clients=10, scheme="iid"),
                                  gamma=1e-3, dtype=jnp.float64)
        w_star = jax_solve_reference(problem)
        hp = JaxHParams(eta=1.0, local_epochs=10)
        yield {algo: jax_run_federated(problem, algo, hp, ROUNDS, w_star=w_star)
               for algo in ("fedsvrg", "fedosaa_svrg")}
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", was)


def test_quickstart_matches_reference(reference_quickstart, capsys):
    got = example("quickstart_torch").main(
        ["--device", "cpu", "--n", str(N), "--dtype", "float64"])
    out = capsys.readouterr().out
    assert "FedOSAA-SVRG final rel-err" in out
    assert len(out.splitlines()[1:ROUNDS + 1]) == ROUNDS
    ref = reference_quickstart
    assert len(got["fedsvrg"].rel_error) == len(ref["fedsvrg"].rel_error) == ROUNDS
    np.testing.assert_allclose(got["fedsvrg"].rel_error, ref["fedsvrg"].rel_error,
                               rtol=1e-4)
    mine, want = got["fedosaa_svrg"], ref["fedosaa_svrg"]
    assert rounds_to(want.rel_error) is not None
    assert abs(rounds_to(mine.rel_error) - rounds_to(want.rel_error)) <= 1, (
        mine.rel_error, want.rel_error)
    assert abs(mine.loss[-1] - want.loss[-1]) <= 1e-10 * abs(want.loss[-1])


def test_logreg_comparison_prints_the_reference_columns(reference_quickstart, capsys):
    mod = example("fl_logreg_comparison_torch")
    got = mod.main(["--device", "cpu", "--rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert list(got) == mod.ALGOS and len(lines) == 1 + len(mod.ALGOS)
    X, y = jax_make("covtype", n=10_000, seed=0)
    want = jax_heterogeneity(jax_partition(X, y, num_clients=10, scheme="iid"))
    assert lines[0] == f"scheme=iid  heterogeneity={want:.3f}"
    ref_cols = columns(reference_quickstart["fedosaa_svrg"].summary())
    assert ref_cols == ["rounds", "loss", "|g|", "relerr", "gcond", "comm", "wall"]
    for algo, line in zip(mod.ALGOS, lines[1:]):
        assert line.split()[0] == algo and columns(line) == ref_cols, line
        assert len(got[algo].rounds) == 2 and np.isfinite(got[algo].loss).all()


def test_fl_train_lm_runs_the_preset(capsys):
    got = example("fl_train_lm_torch").main(
        ["--device", "cpu", "--rounds", "1", "--clients", "2",
         "--docs-per-client", "2", "--seq-len", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert list(got) == ["fedosaa_svrg", "fedsvrg"]
    for algo, line in zip(got, lines[-2:]):
        # the reference's line: "<algo>: loss a -> b |g| c wire dMiB[ch] (es)"
        assert re.fullmatch(rf"{algo}: loss \S+ -> \S+ \|g\| \S+ wire "
                            r"\S+MiB\[identity\] \(\d+s\)", line), line
        assert len(got[algo]["loss_curve"]) == 1


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b", "granite-20b"])
def test_serve_demo_prints_the_reference_lines(arch, capsys):
    toks = example("serve_demo_torch").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill\[2x8\] in \S+s", lines[0]), lines[0]
    assert re.fullmatch(r"decoded 3 tokens/seq in \S+s \(\S+ tok/s batch "
                        r"throughput\)", lines[1]), lines[1]
    assert lines[2] == f"sample token ids: {toks}" and len(toks) == 4


@pytest.mark.parametrize("name, argv", [
    ("quickstart_torch", ["--n", "200", "--rounds", "1"]),
    ("fl_logreg_comparison_torch", ["--rounds", "1"]),
    ("fl_train_lm_torch", ["--rounds", "1"]),
    ("serve_demo_torch", ["--new-tokens", "2"])])
def test_examples_default_to_the_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main(argv)
