"""The sharded runtime (repro_torch/core/sharded.py) in a world of one: a
gloo group of one process on a HashStore, in this process.

  * without a process group the runtime refuses, and starts none;
  * one round against the reference's make_sharded_round_fn on its
    one-device host mesh (x64, the reference's tree_math helpers swapped
    for f64 ones, as tests/test_torch_round.py does), within 1e-7, for
    FedOSAA-SVRG, FedOSAA-SCAFFOLD, GIANT and DANE, and for FedOSAA-SVRG on
    int8 fed the reference's uniforms;
  * at W = 1 every collective is an identity: the sharded round is the vmap
    round bit for bit, in the params and every state tensor, for all ten
    algorithms on the identity and int8 wires and with every fault kind
    behind the deadline gate; its metrics agree within rel 1e-12;
  * run_federated(runtime="sharded") by the loop and the engine gives the
    vmap run's rows and final params; its header and its checkpoints'
    fingerprint say "sharded", and a checkpoint of the other runtime
    refuses to resume;
  * a sink's stop request stops the run;
  * an unknown algorithm and a cohort refuse.
"""
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import (ALGORITHMS, AlgoHParams, convert, init_state,
                              make_round_fn, run_federated)
from repro_torch.core.algorithms import LINE_SEARCH_ALGOS, UPLINK_SCHEMAS
from repro_torch.core.engine import _tensors
from repro_torch.core.sharded import (client_shard, make_sharded_round_fn,
                                      num_client_shards)
from repro_torch.robust import (AsyncConfig, FaultPlan, init_async_comm,
                                init_fault_comm)

from torch_threads import one_torch_thread  # noqa: F401

N, K, L = 2000, 4, 3
DANE = dict(dane_newton_iters=3, dane_cg_iters=10)
#: the bit-for-bit cases' DANE: 2 Newton steps of 5 CG iterations (the
#: reference's own tests'), on synthetic_small, n=400, K=8
SMALL_DANE = dict(dane_newton_iters=2, dane_cg_iters=5)
SMALL_K = 8
#: every fault kind but the history poison, behind the gate
MIXED = dict(seed=7, drop_rate=0.3, stale_rate=0.3, byz_clients=1,
             byz_mode="noise", byz_scale=3.0, dp_sigma=1e-3,
             latency_scale=1.0, latency_shape=1.5)
GATE = dict(deadline=2.0, min_arrivals=2, staleness_alpha=0.5)
METRICS = ("loss", "grad_norm", "theta_mean", "gram_cond_max",
           "gram_cond_mean", "aa_used_min", "aa_clipped_max", "cohort_ess",
           "comm_bytes", "arrivals", "staleness_mean", "staleness_max")


def port_problem(data="covtype", n=N, clients=K):
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem

    X, y = make_binary_classification(data, n=n, seed=0)
    return make_logreg_problem(partition(X, y, clients, "iid", seed=0,
                                         device="cpu"),
                               1e-3, dtype=torch.float64, device="cpu")


def test_refuses_without_a_process_group():
    """No group is initialised yet (this test runs before the module's
    world): the runtime refuses and does not start one."""
    assert not dist.is_initialized()
    prob = port_problem()
    for call in (lambda: make_sharded_round_fn("fedosaa_svrg", prob,
                                               AlgoHParams(), device="cpu"),
                 lambda: run_federated(prob, "fedosaa_svrg", AlgoHParams(), 1,
                                       device="cpu", runtime="sharded"),
                 lambda: num_client_shards()):
        with pytest.raises(ValueError, match="init_process_group"):
            call()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def prob(world):
    return port_problem()


@pytest.fixture(scope="module")
def small(world):
    return port_problem("synthetic_small", 400, SMALL_K)


# ---------------------------------------------------------------------------
# against the reference's sharded round
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(world):
    """reference(algo, channel, **hp) -> (its problem, the state after two
    rounds of its make_sharded_round_fn on make_host_mesh(), the state and
    metrics one round later), with x64 and f64 helpers."""
    import jax
    import jax.numpy as jnp

    import repro.utils.tree_math as jax_tm
    from repro.core import AlgoHParams as RefHP
    from repro.core import init_state as ref_init_state
    from repro.core.sharded import make_sharded_round_fn as ref_sharded
    from repro.data import make_binary_classification as ref_make
    from repro.data import partition as ref_partition
    from repro.launch.mesh import make_host_mesh
    from repro.models.logreg import make_logreg_problem as ref_problem

    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
        mp.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
        mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
        mp.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
        X, y = ref_make("covtype", n=N, seed=0)
        jp = ref_problem(ref_partition(X, y, K, "iid", seed=0), 1e-3,
                         dtype=jnp.float64)
        mesh = make_host_mesh()
        cache = {}

        def run(algo, channel=None, **kw):
            key = (algo, channel, tuple(sorted(kw.items())))
            if key not in cache:
                hp = RefHP(eta=1.0, local_epochs=L, **kw)
                st = ref_init_state(jp, jax.random.PRNGKey(0), hp, channel,
                                    algo)
                rf = jax.jit(ref_sharded(algo, jp, hp, mesh, channel=channel))
                for _ in range(2):
                    st, _ = rf(st)
                cache[key] = (st, *rf(st))
            return cache[key]

        try:
            yield run
        finally:
            jax.config.update("jax_enable_x64", was)


def reference_uniforms(rng, fold: int, d: int, chunk: int = 256):
    """The reference's int8 uniforms of uplink ``fold`` for every client:
    its sharded round splits the same client keys as its vmap round
    (split(split(rng, 3)[2], K); tests/test_torch_round.py)."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    nc = -(-d // chunk)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k, fold), 0), (nc, chunk),
        jnp.float32)) for k in keys]))


REF_CASES = [("fedosaa_svrg", None, {}), ("fedosaa_scaffold", None, {}),
             ("giant", None, {}), ("dane", None, DANE),
             ("fedosaa_svrg", "int8", {})]


@pytest.mark.parametrize("algo,channel,kw", REF_CASES,
                         ids=["fedosaa_svrg", "fedosaa_scaffold", "giant",
                              "dane", "fedosaa_svrg-int8"])
def test_round_matches_reference_sharded_round(prob, reference, algo,
                                               channel, kw):
    """n=2000, K=4, L=3, f64, from the reference's state after two sharded
    rounds: the params within 1e-7 of ‖w‖, the loss within rel 1e-12, the
    wire buffers and SCAFFOLD's control variates within 1e-7 of their
    scale."""
    st, ref_new, ref_m = reference(algo, channel, **kw)
    scaffold = algo == "fedosaa_scaffold"
    start = convert.server_state(st.params, st.t, st.comm,
                                 c=st.c if scaffold else None,
                                 c_k=st.c_k if scaffold else None,
                                 device="cpu")
    draws = None
    if channel == "int8":
        draws = {s.tag: reference_uniforms(st.rng, s.fold, st.params.shape[0])
                 for s in UPLINK_SCHEMAS[algo]}
    rf = make_sharded_round_fn(algo, prob, AlgoHParams(eta=1.0, local_epochs=L,
                                                       **kw),
                               channel=channel, device="cpu")
    new, m = rf(start, draws)
    ref_w = np.asarray(ref_new.params)
    w_norm = np.linalg.norm(ref_w)
    assert np.linalg.norm(new.params.numpy() - ref_w) / w_norm <= 1e-7
    assert new.t == int(ref_new.t)
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-12)
    assert float(m.comm_bytes) == float(ref_m.comm_bytes)
    want = {}
    if scaffold:
        want = {"c": ref_new.c, "c_k": ref_new.c_k}
    if channel is not None:
        want.update({f"{t}/{n}": a for t, b in ref_new.comm.items()
                     for n, a in b.items()})
        assert sorted(new.comm) == sorted(ref_new.comm)
    else:
        assert new.comm is None
    for key, a in want.items():
        got = (getattr(new, key) if "/" not in key
               else new.comm[key.split("/")[0]][key.split("/")[1]])
        a = np.asarray(a)
        scale = max(w_norm, float(np.abs(a).max()))
        assert np.abs(got.numpy() - a).max() <= 1e-7 * scale, key


# ---------------------------------------------------------------------------
# against the vmap round, bit for bit
# ---------------------------------------------------------------------------
def start_state(prob, algo, hp, channel, plan, gate):
    st = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    n = prob.clients.num_clients
    if plan is not None and plan.stale_rate > 0.0:
        st = st._replace(comm=init_fault_comm(st.comm, st.params, n))
    if gate is not None:
        st = st._replace(comm=init_async_comm(st.comm, st.params, n))
    return st


def assert_metrics_agree(a, b):
    for f in METRICS:
        x, y = float(getattr(a, f)), float(getattr(b, f))
        assert (math.isnan(x) and math.isnan(y)) or \
            math.isclose(x, y, rel_tol=1e-12, abs_tol=0.0), (f, x, y)


@pytest.mark.parametrize("wire", ["identity", "int8", "faults"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_world_of_one_is_the_vmap_round_bit_for_bit(small, algo, wire):
    """synthetic_small, n=400, K=8: three rounds of both runtimes from
    init, every state tensor equal bit for bit after each (the faults
    case: every kind but the history poison, on int8, behind the gate
    where the algorithm takes it)."""
    channel = None if wire == "identity" else "int8"
    plan = FaultPlan(**MIXED) if wire == "faults" else None
    gate = (AsyncConfig(**GATE) if wire == "faults"
            and algo not in LINE_SEARCH_ALGOS else None)
    hp = AlgoHParams(eta=1.0, local_epochs=L, **(
        SMALL_DANE if algo == "dane" else {}))
    vmap = make_round_fn(algo, small, hp, channel, device="cpu", faults=plan,
                         async_cfg=gate)
    sharded = make_sharded_round_fn(algo, small, hp, channel=channel,
                                    device="cpu", faults=plan, async_cfg=gate)
    assert sharded.draw_specs == vmap.draw_specs
    assert sharded.capture_refusal is None
    a = b = start_state(small, algo, hp, channel, plan, gate)
    for _ in range(3):
        a, ma = vmap(a)
        b, mb = sharded(b)
        assert a.t == b.t
        ta, tb = _tensors(a), _tensors(b)
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert_metrics_agree(ma, mb)


def test_run_federated_sharded_by_loop_and_engine(prob):
    """run_federated(runtime="sharded"), by the loop and by the engine
    (chunks of 2, eager on the CPU), on int8 with faults behind the gate:
    the vmap run's loss and bytes exactly, its other rows within rel
    1e-12, its final params bit for bit; the header says "sharded"."""
    from repro_torch.obs import MemorySink

    kw = dict(channel="int8", device="cpu", faults=FaultPlan(**MIXED),
              async_cfg=AsyncConfig(**GATE))
    hp = AlgoHParams(eta=1.0, local_epochs=L)
    want = run_federated(prob, "fedosaa_svrg", hp, 5, **kw)
    for chunk in (None, 2):
        sink = MemorySink()
        h = run_federated(prob, "fedosaa_svrg", hp, 5, chunk=chunk,
                          runtime="sharded", sinks=[sink], **kw)
        assert sink.header["runtime"] == "sharded"
        assert len(sink.rows) == 5
        assert torch.equal(h.final_params, want.final_params)
        np.testing.assert_array_equal(h.loss, want.loss)
        np.testing.assert_array_equal(h.comm_bytes, want.comm_bytes)
        np.testing.assert_allclose(h.theta_mean, want.theta_mean, rtol=1e-12)
        np.testing.assert_allclose(h.staleness_mean, want.staleness_mean,
                                   rtol=1e-12)


class StopAfter:
    """A sink that asks the run to stop once it has seen ``n`` rows."""

    def __init__(self, n: int):
        self.n, self.rows = n, 0

    def open(self, header):
        pass

    def emit(self, rows):
        self.rows += len(rows)

    def close(self, footer):
        pass

    @property
    def stop_requested(self) -> bool:
        return self.rows >= self.n


@pytest.mark.parametrize("chunk", [None, 2])
def test_a_sink_stop_stops_the_run(prob, chunk):
    """Rank 0's sink asks to stop after 3 rows: the run (every rank, here
    the one) stops after round 3 (the loop) or that chunk (the engine)."""
    h = run_federated(prob, "fedosaa_svrg", AlgoHParams(eta=1.0, local_epochs=L),
                      10, device="cpu", runtime="sharded", chunk=chunk,
                      sinks=[StopAfter(3)])
    assert len(h.rounds) == (3 if chunk is None else 4)


def test_fingerprint_says_sharded_and_the_other_runtime_refuses(prob,
                                                                tmp_path):
    """A sharded run's checkpoint carries the reference's fingerprint of
    the sharded runtime; resuming it by the vmap runtime, or a vmap run's
    checkpoint by the sharded runtime, raises CheckpointConfigMismatch."""
    from repro.core.server import checkpoint_config_fingerprint as ref_fp
    from repro_torch.checkpoint import (CheckpointConfigMismatch,
                                        CheckpointPolicy)

    hp = AlgoHParams(eta=1.0, local_epochs=L)
    for runtime, other in (("sharded", "vmap"), ("vmap", "sharded")):
        d = str(tmp_path / runtime)
        run_federated(prob, "fedosaa_svrg", hp, 2, channel="int8",
                      device="cpu", runtime=runtime,
                      checkpoint=CheckpointPolicy(directory=d, every=2,
                                                  mode="sync"))
        manifest = json.loads(open(os.path.join(
            d, "ckpt_00000002", "manifest.json")).read())
        assert manifest["config"] == ref_fp("fedosaa_svrg", runtime,
                                            "int8+ef", K, None)
        assert manifest["files"] == ["shards_p0000.npz"]
        with pytest.raises(CheckpointConfigMismatch, match="runtime"):
            run_federated(prob, "fedosaa_svrg", hp, 4, channel="int8",
                          device="cpu", runtime=other,
                          checkpoint=CheckpointPolicy(directory=d, every=2,
                                                      mode="sync"),
                          resume="auto")


def test_refusals(prob):
    """An unknown algorithm or runtime, a cohort (by participation or by
    size), and sync_gather checkpoints refuse; K = 4 divides over one
    rank."""
    from repro_torch.checkpoint import CheckpointPolicy

    with pytest.raises(ValueError, match="unknown algorithm"):
        make_sharded_round_fn("fedprox", prob, AlgoHParams(), device="cpu")
    with pytest.raises(ValueError, match="unknown runtime"):
        run_federated(prob, "fedosaa_svrg", AlgoHParams(), 1, device="cpu",
                      runtime="pmap")
    for hp in (AlgoHParams(participation=0.5), AlgoHParams(cohort_size=4)):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            make_sharded_round_fn("fedosaa_svrg", prob, hp, device="cpu")
    with pytest.raises(ValueError, match="sync_gather"):
        run_federated(prob, "fedosaa_svrg", AlgoHParams(), 1, device="cpu",
                      runtime="sharded",
                      checkpoint=CheckpointPolicy(directory="unused",
                                                  mode="sync_gather"))
    shard = client_shard(K)
    assert (shard.rank, shard.world, shard.rows) == (0, 1, slice(0, K))
    assert list(shard.ids) == list(range(K))


def test_engine_raises_a_round_s_capture_refusal(small, monkeypatch):
    """A sharded round on a gloo group on the card names its refusal (gloo
    stages CUDA tensors through the host); the engine's capture raises it
    before it touches the card. On the CPU the round names none and the
    engine runs it eagerly (test_run_federated_sharded_by_loop_and_engine)."""
    from repro_torch.core.engine import make_chunk_runner

    hp = AlgoHParams(eta=1.0, local_epochs=L)
    rf = make_sharded_round_fn("fedosaa_svrg", small, hp, device="cpu")
    assert rf.capture_refusal is None and rf.capture_error_mode == "global"
    monkeypatch.setattr(rf, "capture_refusal", "a gloo group on the card",
                        raising=False)
    runner = make_chunk_runner(rf, 2)
    with pytest.raises(ValueError, match="engine: a gloo group on the card"):
        runner._capture(init_state(rf.rank_problem, device="cpu",
                                   algo="fedosaa_svrg"))
