"""Resuming the port from its checkpoints, and carrying state across from
the reference's (repro_torch/checkpoint through core/server.run_federated
and core/engine.run_rounds, on the CPU).

  * a run killed during its second save resumes with ``resume="auto"``
    from the newest complete checkpoint and finishes bit for bit the run
    that was never killed: every History column, every telemetry row from
    the resume round on, and every tensor of the final state (the params,
    both comm tags, the carried AA columns, the gate's buffer rows and int32
    ages, the fault anchors) — by the loop, by the engine, saved by one and
    resumed by the other, dense and in a C=4-of-8 cohort, and for each of
    the ten algorithms on the engine;
  * checkpointing keeps the engine's one host read a chunk (``_fetch``);
  * a checkpoint of another fault plan refuses to resume;
  * the port's run fingerprint is the reference's;
  * the reference's ``verify_checkpoint`` accepts the port's checkpoints,
    and the port's ``load_latest`` restores the reference's into a port
    template, equal to ``convert.server_state`` of the reference's state.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointConfigMismatch,
                                    CheckpointManager, CheckpointPolicy,
                                    list_checkpoints, load_checkpoint,
                                    load_latest)
from repro_torch.checkpoint.sharded_ckpt import _leaf_keys
from repro_torch.core import (ALGORITHMS, AAConfig, AlgoHParams, convert,
                              engine, init_state, make_round_fn,
                              run_federated, run_rounds)
from repro_torch.core.algorithms import LINE_SEARCH_ALGOS, NEWTON_ALGOS
from repro_torch.core.server import checkpoint_config_fingerprint
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.obs import MemorySink
from repro_torch.robust import (AsyncConfig, FaultPlan, FaultyFs,
                                FSFaultPlan, init_async_comm,
                                init_fault_comm)

from torch_threads import one_torch_thread  # noqa: F401

K = 8
#: the reference test's adversarial case: int8 EF residuals and refs, two
#: carried AA columns, heavy-tailed latencies behind the deadline gate
RICH_HP = dict(eta=0.5, local_epochs=3, carry_history=2,
               aa=AAConfig(tikhonov=1e-6, damping=0.7))
LATENCY_PLAN = dict(seed=5, latency_scale=1.0, latency_shape=1.5)
GATE = dict(deadline=2.0, min_arrivals=2, staleness_alpha=0.5)
HISTORY_FIELDS = ("rounds", "loss", "grad_norm", "rel_error", "theta_mean",
                  "comm_bytes", "gram_cond_max", "arrivals", "staleness_mean",
                  "staleness_max")


@pytest.fixture(scope="module")
def setup():
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    clients = partition(X, y, K, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")
    w_star = torch.linspace(-1.0, 1.0, clients.x.shape[-1],
                            dtype=torch.float64)
    return prob, w_star


def start_state(prob, algo, hp, channel, plan, gate):
    """run_federated's initial state for the run."""
    st = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    if plan is not None and plan.stale_rate > 0.0:
        st = st._replace(comm=init_fault_comm(st.comm, st.params, K))
    if gate is not None:
        st = st._replace(comm=init_async_comm(st.comm, st.params, K))
    return st


def straight_state(prob, algo, hp, channel, plan, gate, rounds):
    """The state after ``rounds`` rounds of the per-round loop."""
    rf = make_round_fn(algo, prob, hp, channel, device="cpu", faults=plan,
                       async_cfg=gate)
    st = start_state(prob, algo, hp, channel, plan, gate)
    for _ in range(rounds):
        st, _ = rf(st)
    return st


def assert_same_tree(a, b):
    """Every leaf of two states (or restored trees) bit for bit, dtypes and
    the round counter included."""
    la, lb = _leaf_keys(a), _leaf_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert type(x) is type(y) and x == y, key


def kill_and_resume(tmp_path, prob, w_star, algo, hp, rounds, save_chunk,
                    resume_chunk, channel="int8", plan=None, gate=None,
                    mode="sync"):
    """Straight run; a run whose save 2 dies after its first write; the
    ``resume="auto"`` run. Returns the three histories and the resumed
    run's sink, after the protocol's checks."""
    d = str(tmp_path)
    pol = CheckpointPolicy(directory=d, every=2, keep=0, mode=mode)
    kw = dict(problem=prob, algo=algo, hp=hp, num_rounds=rounds,
              w_star=w_star, channel=channel, device="cpu", faults=plan,
              async_cfg=gate)
    straight = run_federated(chunk=resume_chunk, **kw)
    fs = FaultyFs(FSFaultPlan(kill_at_save=2, kill_after_writes=1))
    run_federated(chunk=save_chunk, checkpoint=pol, checkpoint_fs=fs, **kw)
    assert [r for r, _ in list_checkpoints(d)] == [2]
    assert any(n.startswith(".tmp-") for n in os.listdir(d))
    sink = MemorySink()
    resumed = run_federated(chunk=resume_chunk, checkpoint=pol,
                            resume="auto", sinks=[sink], **kw)
    assert sink.header["start_round"] == 2
    assert [r["round"] for r in sink.rows] == list(range(2, rounds))
    for f in HISTORY_FIELDS[1:]:
        a, b = getattr(resumed, f), getattr(straight, f)
        if f == "comm_bytes":   # cumulative: the resumed run counts its own
            a, b = (np.diff(np.concatenate([[0.0], v])) for v in (a, b))
        np.testing.assert_array_equal(a, b[2:], err_msg=f)
    np.testing.assert_array_equal(resumed.rounds, np.arange(2, rounds))
    assert torch.equal(resumed.final_params, straight.final_params)
    # the resumed run's own saves join the survivor; its last holds the
    # final state, which equals the straight run's in every tensor
    assert [r for r, _ in list_checkpoints(d)] == list(range(rounds, 0, -2))
    final, manifest = load_checkpoint(
        os.path.join(d, f"ckpt_{rounds:08d}"),
        start_state(prob, algo, hp, channel, plan, gate))
    assert manifest["round"] == rounds and final.t == rounds
    assert_same_tree(final, straight_state(prob, algo, hp, channel, plan,
                                           gate, rounds))
    return straight, resumed, sink


PATHS = [(None, None), (2, 2), (None, 2), (2, None)]


@pytest.mark.parametrize("cohort", [None, 4])
@pytest.mark.parametrize("save_chunk,resume_chunk", PATHS,
                         ids=["loop", "engine", "loop-engine", "engine-loop"])
def test_kill_during_save_then_resume_auto(setup, tmp_path, save_chunk,
                                           resume_chunk, cohort):
    """The reference test's acceptance scenario on the port: int8, two
    carried AA columns, latency faults and the gate, dense and C=4 of 8,
    by the loop and the engine and across the two; the async save mode on
    the engine, sync on the loop."""
    prob, w_star = setup
    hp = AlgoHParams(**RICH_HP, cohort_size=cohort)
    kill_and_resume(tmp_path, prob, w_star, "fedosaa_svrg", hp, 6, save_chunk,
                    resume_chunk, plan=FaultPlan(**LATENCY_PLAN),
                    gate=AsyncConfig(**GATE),
                    mode="sync" if save_chunk is None else "async")


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_algorithm_resumes_on_the_engine(setup, tmp_path, algo):
    """All ten algorithms on the engine, int8, stale anchors and latencies,
    the gate where the aggregation is delta-form, carried columns for the
    trajectory family: 4 rounds, saved at 2."""
    prob, w_star = setup
    knobs = ({"dane_newton_iters": 1, "dane_cg_iters": 3} if algo == "dane"
             else {} if algo in NEWTON_ALGOS else {"carry_history": 2})
    hp = AlgoHParams(eta=0.5, local_epochs=3, **knobs)
    gate = None if algo in LINE_SEARCH_ALGOS else AsyncConfig(**GATE)
    plan = FaultPlan(stale_rate=0.3, **LATENCY_PLAN)
    kill_and_resume(tmp_path, prob, w_star, algo, hp, 4, 2, 2, plan=plan,
                    gate=gate, mode="async")


def test_resume_at_the_budget_returns_an_empty_history(setup, tmp_path):
    prob, w_star = setup
    hp = AlgoHParams(eta=0.5, local_epochs=3)
    pol = CheckpointPolicy(directory=str(tmp_path), every=2, mode="sync")
    kw = dict(w_star=w_star, device="cpu", checkpoint=pol)
    run_federated(prob, "fedosaa_svrg", hp, 2, **kw)
    for chunk in (None, 2):
        sink = MemorySink()
        h = run_federated(prob, "fedosaa_svrg", hp, 2, resume="auto",
                          chunk=chunk, sinks=[sink], **kw)
        assert len(h.rounds) == len(h.loss) == 0
        assert sink.header["start_round"] == 2 and sink.rows == []
        assert sink.footer["rounds"] == 0
    # an explicit path resumes too; "auto" without a policy raises
    path = os.path.join(str(tmp_path), "ckpt_00000002")
    h = run_federated(prob, "fedosaa_svrg", hp, 3, resume=path, chunk=2,
                      **kw)
    np.testing.assert_array_equal(h.rounds, [2])
    with pytest.raises(ValueError, match="needs a checkpoint policy"):
        run_federated(prob, "fedosaa_svrg", hp, 3, resume="auto",
                      device="cpu")


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_checkpointing_keeps_one_read_a_chunk(setup, tmp_path, monkeypatch,
                                              mode):
    """With checkpointing attached the engine still reads the device once a
    chunk (``engine._fetch``); the save reads the state through its own
    copies."""
    prob, _ = setup
    hp = AlgoHParams(eta=0.5, local_epochs=3)
    rf = make_round_fn("fedosaa_svrg", prob, hp, "int8", device="cpu")
    state = init_state(prob, device="cpu", channel="int8",
                       algo="fedosaa_svrg", hp=hp)
    calls = []
    fetch = engine._fetch
    monkeypatch.setattr(engine, "_fetch",
                        lambda r: (calls.append(1), fetch(r))[1])
    mgr = CheckpointManager(CheckpointPolicy(
        directory=str(tmp_path), every=4, mode=mode))
    sink = MemorySink()
    _, trace = run_rounds(rf, state, 8, chunk=4, sinks=[sink], checkpoint=mgr)
    assert trace.num_rounds == 8
    assert mgr.saves_completed == 2
    assert len(calls) == 2
    assert sink.footer["checkpoint_bytes"] > 0
    assert sink.footer["checkpoint_failures"] == 0


def test_resume_refuses_mismatched_run_config(setup, tmp_path):
    prob, w_star = setup
    hp = AlgoHParams(**RICH_HP)
    pol = CheckpointPolicy(directory=str(tmp_path), every=2, mode="sync")
    kw = dict(w_star=w_star, channel="int8", device="cpu", chunk=2,
              checkpoint=pol)
    run_federated(prob, "fedosaa_svrg", hp, 2, faults=FaultPlan(**LATENCY_PLAN),
                  async_cfg=AsyncConfig(**GATE), **kw)
    with pytest.raises(CheckpointConfigMismatch):
        run_federated(prob, "fedosaa_svrg", hp, 4, resume="auto", **kw)
    with pytest.raises(CheckpointConfigMismatch):
        run_federated(prob, "fedosaa_svrg", hp, 4, resume="auto",
                      faults=FaultPlan(seed=6, latency_scale=1.0,
                                       latency_shape=1.5),
                      async_cfg=AsyncConfig(**GATE), **kw)


def test_fingerprint_is_the_reference_s():
    from repro.core.server import checkpoint_config_fingerprint as ref_fp
    from repro.robust import AsyncConfig as RefGate
    from repro.robust import FaultPlan as RefPlan

    plan = dict(LATENCY_PLAN, seed=3, drop_rate=0.1, stale_rate=0.2,
                byz_clients=1, byz_mode="history", dp_sigma=1e-3)
    for faults, gate in ((None, None), (plan, GATE)):
        ours = checkpoint_config_fingerprint(
            "fedosaa_svrg", "vmap", "int8", 8, 4,
            FaultPlan(**faults) if faults else None,
            AsyncConfig(**gate) if gate else None)
        ref = ref_fp("fedosaa_svrg", "vmap", "int8", 8, 4,
                     RefPlan(**faults) if faults else None,
                     RefGate(**gate) if gate else None)
        assert ours == ref


# ---------------------------------------------------------------------------
# carried across: the reference's checkpoints and the port's, both ways
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_ckpts(tmp_path_factory):
    """Checkpoints the reference's run_federated wrote after 2 rounds
    (float32, the reference's default): FedOSAA-SVRG on int8 with two
    carried columns, stale anchors and latencies behind the gate; SCAFFOLD
    (its c and c_k). Returns {name: (directory, the reference's restored
    state as numpy, its config)}."""
    import jax

    from repro.checkpoint import CheckpointPolicy as RefPolicy
    from repro.checkpoint import load_latest as ref_load_latest
    from repro.comm import make_channel as ref_channel
    from repro.core import AlgoHParams as RefHP
    from repro.core import init_state as ref_init_state
    from repro.core import run_federated as ref_run
    from repro.core.anderson import AAConfig as RefAA
    from repro.data import make_binary_classification as ref_make
    from repro.data import partition as ref_partition
    from repro.models.logreg import make_logreg_problem as ref_problem
    from repro.robust import AsyncConfig as RefGate
    from repro.robust import FaultPlan as RefPlan
    from repro.robust import init_async_comm as ref_async
    from repro.robust import init_fault_comm as ref_fault

    X, y = ref_make("synthetic_small", n=400, seed=0)
    rprob = ref_problem(ref_partition(X, y, K, "iid", seed=0), 1e-3)
    runs = {
        "svrg": dict(algo="fedosaa_svrg", channel="int8",
                     hp=dict(eta=0.5, local_epochs=3, carry_history=2),
                     faults=dict(stale_rate=0.3, **LATENCY_PLAN), gate=GATE),
        "scaffold": dict(algo="scaffold", channel=None,
                         hp=dict(eta=0.5, local_epochs=3), faults=None,
                         gate=None),
    }
    out = {}
    for name, r in runs.items():
        d = str(tmp_path_factory.mktemp(f"ref_{name}"))
        hp = RefHP(**r["hp"], aa=RefAA(tikhonov=1e-6, damping=0.7))
        plan = RefPlan(**r["faults"]) if r["faults"] else None
        gate = RefGate(**r["gate"]) if r["gate"] else None
        ref_run(rprob, r["algo"], hp, 2, rng=0, channel=r["channel"],
                faults=plan, async_cfg=gate,
                checkpoint=RefPolicy(directory=d, every=2, mode="sync"))
        ch = ref_channel(r["channel"])
        like = ref_init_state(rprob, jax.random.PRNGKey(0), hp, ch, r["algo"])
        if plan is not None:
            like = like._replace(comm=ref_fault(like.comm, like.params, K))
        if gate is not None:
            like = like._replace(comm=ref_async(like.comm, like.params, K))
        state, manifest = ref_load_latest(d, like)
        out[name] = (d, jax.tree.map(np.asarray, state), r)
    return out


def port_template(r):
    """The port's fresh state for a reference run's configuration, in
    float32 (the reference's default dtype)."""
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    prob = make_logreg_problem(partition(X, y, K, "iid", seed=0,
                                         device="cpu"),
                               1e-3, dtype=torch.float32, device="cpu")
    hp = AlgoHParams(**r["hp"])
    plan = FaultPlan(**r["faults"]) if r["faults"] else None
    gate = AsyncConfig(**r["gate"]) if r["gate"] else None
    return start_state(prob, r["algo"], hp, r["channel"], plan, gate)


@pytest.mark.parametrize("name", ["svrg", "scaffold"])
def test_port_restores_the_reference_s_checkpoint(reference_ckpts, name):
    """The port's load_latest restores the reference's checkpoint into a
    port template (its ``.rng``, and ``.c``/``.c_k`` outside SCAFFOLD,
    ignored), equal to convert.server_state of the reference's state."""
    d, ref, r = reference_ckpts[name]
    state, manifest = load_latest(d, port_template(r))
    assert manifest["round"] == 2 and manifest["inventory"]["rng"]
    scaffold = r["algo"] == "scaffold"
    want = convert.server_state(
        ref.params, ref.t, ref.comm, c=ref.c if scaffold else None,
        c_k=ref.c_k if scaffold else None,
        hist_s=None if scaffold else ref.hist_s,
        hist_y=None if scaffold else ref.hist_y, device="cpu")
    assert state.t == 2
    assert_same_tree(state, want)


def test_reference_verifies_the_port_s_checkpoint(reference_ckpts, tmp_path):
    """A checkpoint the port wrote (same run as the reference's FedOSAA-SVRG
    one) passes the reference's verify_checkpoint; its manifest's config is
    the reference's fingerprint of that run, and its leaves are the
    reference's, less its ``.rng`` and the SCAFFOLD-only ``.c``/``.c_k``."""
    from repro.checkpoint import verify_checkpoint as ref_verify

    ref_dir, _, r = reference_ckpts["svrg"]
    template = port_template(r)
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    prob = make_logreg_problem(partition(X, y, K, "iid", seed=0,
                                         device="cpu"),
                               1e-3, dtype=torch.float32, device="cpu")
    d = str(tmp_path)
    run_federated(prob, "fedosaa_svrg", AlgoHParams(**r["hp"]), 2,
                  channel="int8", device="cpu",
                  faults=FaultPlan(**r["faults"]),
                  async_cfg=AsyncConfig(**r["gate"]),
                  checkpoint=CheckpointPolicy(directory=d, every=2,
                                              mode="sync"))
    path = os.path.join(d, "ckpt_00000002")
    found = ref_verify(path)
    assert found is not None
    manifest, data = found
    ref_manifest, _ = ref_verify(os.path.join(ref_dir, "ckpt_00000002"))
    assert manifest["config"] == ref_manifest["config"]
    assert set(data) == set(ref_manifest["leaves"]) - {".rng", ".c", ".c_k"}
    for key, rec in manifest["leaves"].items():
        assert rec["dtype"] == ref_manifest["leaves"][key]["dtype"], key
    state, _ = load_latest(d, template)
    assert state.t == 2
