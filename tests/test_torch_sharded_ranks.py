"""The sharded runtime (repro_torch/core/sharded.py) in worlds of 2 and 4
gloo processes on the CPU: synthetic_small, n=400, K=8 iid, f64.

Each world is ONE spawn of this file as a script (``spawn_world``; the
processes meet on a FileStore under the test's temporary directory, with a
60 s collective timeout and a subprocess timeout, so a hang fails the test
instead of stalling the run). Every rank runs every case of its world and
saves what it saw; the tests below read those results:

  * one round of each family (FedOSAA-SVRG, -SCAFFOLD, -AVG, L-BFGS, GIANT
    with the line search, DANE; FedOSAA-SVRG on int8 fed the reference's
    uniforms) from the reference's state (convert.server_state, each rank
    its rows), within 1e-7 of the port's vmap round and of the reference's
    round with f64 helpers, on every state tensor;
  * all fault kinds at once behind the deadline gate, the history poison,
    and carried AA columns with minibatch steps: one round from a common
    state within 1e-7 of the vmap round (test_torch_faults.py and
    test_torch_algorithms.py hold those rounds against the reference);
  * the engine (``chunk=3``) equals the loop bit for bit, and a run's
    rounds to a gradient norm of 1e-4 are the vmap run's within one round;
  * the replicated params are bit-equal across the ranks after every run;
  * a W = 2 run saving every 2 rounds, one shard file per rank, and a run
    resumed from its first save end bit for bit as the straight run; the
    reference's verify_checkpoint accepts that checkpoint; a W = 4 world
    restores it, each rank's rows bit-equal to the saved rows;
  * the reference's sharded-runtime checkpoint restores into W = 2, each
    rank's rows those of convert.server_state of the reference's state;
  * K = 6 does not divide over 4 ranks: the round refuses.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
K, L = 8, 3
HP = dict(eta=1.0, local_epochs=L)
DANE = dict(dane_newton_iters=3, dane_cg_iters=10)
#: (case, algorithm, channel, AlgoHParams knobs) of the rounds from the
#: reference's state
FAMILY = (("fedosaa_svrg", "fedosaa_svrg", None, {}),
          ("fedosaa_scaffold", "fedosaa_scaffold", None, {}),
          ("fedosaa_avg", "fedosaa_avg", None, {}),
          ("lbfgs", "lbfgs", None, {}),
          ("giant_ls", "giant", None, {"line_search": True}),
          ("dane", "dane", None, DANE),
          ("fedosaa_svrg_int8", "fedosaa_svrg", "int8", {}))
#: every fault kind but the history poison, behind the gate
#: (tests/test_torch_faults.py's MIXED and GATE)
MIXED = dict(seed=7, drop_rate=0.3, stale_rate=0.3, byz_clients=1,
             byz_mode="noise", byz_scale=3.0, dp_sigma=1e-3,
             latency_scale=1.0, latency_shape=1.5)
GATE = dict(deadline=2.0, min_arrivals=2, staleness_alpha=0.5)
POISON = dict(seed=2, byz_clients=2, byz_mode="history", byz_scale=1e6)
#: (case, algorithm, channel, knobs, fault plan, gate) of the rounds from
#: a common state the vmap runtime reached in two rounds
OWN = (("mixed_gate", "fedosaa_svrg", "int8", {}, MIXED, GATE),
       ("scaffold_mixed_gate", "fedosaa_scaffold", "int8", {}, MIXED, GATE),
       ("history_poison", "fedosaa_svrg", None, {}, POISON, None),
       ("carry_minibatch", "fedosaa_svrg", "int8",
        dict(carry_history=2, batch_size=16), None, None))
#: the checkpointed run: int8 buffers, carried columns, stale anchors and
#: latencies behind the gate
CKPT_HP = dict(eta=0.5, local_epochs=L, carry_history=2)
CKPT_PLAN = dict(seed=5, stale_rate=0.3, latency_scale=1.0, latency_shape=1.5)
CKPT_ROUNDS = 6
#: the rounds-to-target run: FedOSAA-SVRG to a gradient norm below 1e-4
TARGET_ROUNDS, TARGET_GRAD_NORM = 25, 1e-4
SPAWN_TIMEOUT = 150.0


def port_problem(dtype=torch.float64, clients=K):
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem

    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    return make_logreg_problem(partition(X, y, clients, "iid", seed=0,
                                         device="cpu"),
                               1e-3, dtype=dtype, device="cpu")


def rows_of(state, sl):
    """A rank's state: its rows of every per-client tensor."""
    def cut(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[sl].clone()
    return state._replace(c_k=cut(state.c_k), hist_s=cut(state.hist_s),
                          hist_y=cut(state.hist_y), comm=cut(state.comm))


def joined(states):
    """The global state from the ranks' states (rank order), the
    replicated fields checked bit-equal across ranks."""
    first = states[0]
    for s in states[1:]:
        assert torch.equal(s.params, first.params) and s.t == first.t
        assert (s.c is None) == (first.c is None)
        if s.c is not None:
            assert torch.equal(s.c, first.c)

    def cat(vs):
        if vs[0] is None:
            return None
        if isinstance(vs[0], dict):
            return {k: cat([v[k] for v in vs]) for k in vs[0]}
        return torch.cat(vs)
    return first._replace(**{f: cat([getattr(s, f) for s in states])
                             for f in ("c_k", "hist_s", "hist_y", "comm")})


def run_state(prob, algo, hp, channel, plan, gate, rounds):
    """run_federated's start state, advanced ``rounds`` vmap rounds."""
    from repro_torch.core import init_state, make_round_fn
    from repro_torch.robust import init_async_comm, init_fault_comm

    st = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    n = prob.clients.num_clients
    if plan is not None and plan.stale_rate > 0.0:
        st = st._replace(comm=init_fault_comm(st.comm, st.params, n))
    if gate is not None:
        st = st._replace(comm=init_async_comm(st.comm, st.params, n))
    rf = make_round_fn(algo, prob, hp, channel, device="cpu", faults=plan,
                       async_cfg=gate)
    for _ in range(rounds):
        st, _ = rf(st)
    return st


# ---------------------------------------------------------------------------
# the ranks' side: this file run as a script by spawn_world
# ---------------------------------------------------------------------------
def child(workdir: Path) -> None:
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint import (CheckpointPolicy, load_checkpoint,
                                        load_latest)
    from repro_torch.comm import make_channel
    from repro_torch.core import AlgoHParams, run_federated
    from repro_torch.core.sharded import (client_shard, init_file_world,
                                          make_sharded_round_fn,
                                          shard_clients)
    from repro_torch.core.server import checkpoint_config_fingerprint
    from repro_torch.robust import AsyncConfig, FaultPlan

    init_file_world(timeout_s=60.0)
    rank, W = dist.get_rank(), dist.get_world_size()
    inp = torch.load(workdir.parent / "inputs.pt", weights_only=False)
    prob = port_problem()
    sl = client_shard(K).rows
    out = {"rounds": {}, "runs": {}}

    def same_everywhere(t: torch.Tensor) -> bool:
        parts = [torch.empty_like(t) for _ in range(W)]
        dist.all_gather(parts, t)
        return all(torch.equal(p, t) for p in parts)

    # one round from a common state, fed the given draws (or its own)
    for name, (algo, channel, kw, plan, gate, start, draws) in \
            inp["rounds"].items():
        rf = make_sharded_round_fn(
            algo, prob, AlgoHParams(**HP, **kw), channel=channel,
            device="cpu", faults=FaultPlan(**plan) if plan else None,
            async_cfg=AsyncConfig(**gate) if gate else None)
        d = None if draws is None else {n: v[sl] for n, v in draws.items()}
        new, m = rf(rows_of(start, sl), d)
        out["rounds"][name] = dict(state=new, loss=float(m.loss),
                                   same=same_everywhere(new.params))

    # whole runs: the loop and the engine
    for name, (kw, chunk) in inp["runs"].items():
        kw = dict(kw)
        hp = AlgoHParams(**kw.pop("hp"))
        plan, gate = kw.pop("plan"), kw.pop("gate")
        h = run_federated(prob, hp=hp, device="cpu", chunk=chunk,
                          runtime="sharded",
                          faults=FaultPlan(**plan) if plan else None,
                          async_cfg=AsyncConfig(**gate) if gate else None,
                          **kw)
        out["runs"][name] = dict(h=h, same=same_everywhere(h.final_params))

    ckpt = dict(hp=AlgoHParams(**CKPT_HP), channel="int8",
                faults=FaultPlan(**CKPT_PLAN), async_cfg=AsyncConfig(**GATE))
    shard = client_shard(K)
    if W == 2:
        d = inp["ckpt_dir"]
        pol = CheckpointPolicy(directory=d, every=2, keep=0, mode="async")
        straight = run_federated(prob, "fedosaa_svrg",
                                 num_rounds=CKPT_ROUNDS, device="cpu",
                                 runtime="sharded", checkpoint=pol, **ckpt)
        resumed = run_federated(prob, "fedosaa_svrg", num_rounds=CKPT_ROUNDS,
                                device="cpu", runtime="sharded",
                                resume=os.path.join(d, "ckpt_00000002"),
                                **ckpt)
        out["ckpt"] = dict(straight=straight, resumed=resumed)
        # the reference's sharded-runtime checkpoint, restored into W = 2
        r = inp["ref_ckpt"]
        p32 = port_problem(torch.float32)
        plan, gate = FaultPlan(**r["faults"]), AsyncConfig(**r["gate"])
        tmpl = run_state(
            dataclasses.replace(p32, clients=shard_clients(p32.clients)),
            r["algo"], AlgoHParams(**r["hp"]), r["channel"], plan, gate, 0)
        fp = checkpoint_config_fingerprint(
            r["algo"], "sharded", make_channel(r["channel"]).name, K, None,
            plan, gate)
        out["ref_restore"] = load_latest(r["dir"], tmpl, expect_config=fp,
                                         shard=shard)[0]
    else:
        # a W = 2 checkpoint, restored at W = 4
        path = os.path.join(inp["ckpt_dir"], "ckpt_00000004")
        template = run_state(
            dataclasses.replace(prob, clients=shard_clients(prob.clients)),
            "fedosaa_svrg", ckpt["hp"], "int8", ckpt["faults"],
            ckpt["async_cfg"], 0)
        out["restore"] = load_checkpoint(path, template, shard=shard)[0]
        try:
            client_shard(6)
        except ValueError as e:
            out["refusal"] = str(e)
        try:
            make_sharded_round_fn("fedosaa_svrg", port_problem(clients=6),
                                  AlgoHParams(**HP), device="cpu")
        except ValueError as e:
            out["round_refusal"] = str(e)
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests' side
# ---------------------------------------------------------------------------
def reference_uniforms(rng, fold: int, d: int, chunk: int = 256):
    """The reference's int8 uniforms of uplink ``fold`` for every client of
    the round that starts from key ``rng`` (tests/test_torch_round.py)."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    nc = -(-d // chunk)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k, fold), 0), (nc, chunk),
        jnp.float32)) for k in keys]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """What the worlds read (``inputs.pt``): the rounds' start states and
    draws, the runs' arguments, the checkpoint directories; and what the
    tests hold the worlds against: the vmap rounds and runs, the
    reference's rounds (x64, f64 helpers) and its sharded checkpoint."""
    import jax
    import jax.numpy as jnp

    import repro.utils.tree_math as jax_tm
    from repro.checkpoint import CheckpointPolicy as RefPolicy
    from repro.checkpoint import load_latest as ref_load_latest
    from repro.comm import make_channel as ref_channel
    from repro.core import AlgoHParams as RefHP
    from repro.core import init_state as ref_init_state
    from repro.core import make_round_fn as ref_make_round_fn
    from repro.core import run_federated as ref_run
    from repro.data import make_binary_classification as ref_make
    from repro.data import partition as ref_partition
    from repro.models.logreg import make_logreg_problem as ref_problem
    from repro.robust import AsyncConfig as RefGate
    from repro.robust import FaultPlan as RefPlan
    from repro.robust import init_async_comm as ref_async
    from repro.robust import init_fault_comm as ref_fault
    from repro_torch.core import (UPLINK_SCHEMAS, AlgoHParams, convert,
                                  make_round_fn, run_federated)
    from repro_torch.robust import AsyncConfig, FaultPlan

    base = tmp_path_factory.mktemp("sharded_ranks")
    X, y = ref_make("synthetic_small", n=400, seed=0)
    # the reference's checkpoint of its sharded runtime after 2 rounds
    # (float32, its default dtype; its engine, one chunk of 2)
    ref_dir = str(base / "ref_ckpt")
    rhp, rplan, rgate = RefHP(**CKPT_HP), RefPlan(**CKPT_PLAN), RefGate(**GATE)
    rprob = ref_problem(ref_partition(X, y, K, "iid", seed=0), 1e-3)
    ref_run(rprob, "fedosaa_svrg", rhp, 2, rng=0, channel="int8",
            faults=rplan, async_cfg=rgate, runtime="sharded", chunk=2,
            checkpoint=RefPolicy(directory=ref_dir, every=2, mode="sync"))
    like = ref_init_state(rprob, jax.random.PRNGKey(0), rhp,
                          ref_channel("int8"), "fedosaa_svrg")
    like = like._replace(comm=ref_async(ref_fault(like.comm, like.params, K),
                                        like.params, K))
    ref_ckpt_state = jax.tree.map(np.asarray, ref_load_latest(ref_dir, like)[0])

    pp = port_problem()
    rounds, want = {}, {}
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
            mp.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
            mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
            mp.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
            jp = ref_problem(ref_partition(X, y, K, "iid", seed=0), 1e-3,
                             dtype=jnp.float64)
            d = int(jp.clients.x.shape[-1])
            for name, algo, channel, kw in FAMILY:
                jhp = RefHP(**HP, aa_impl="tree", local_impl="tree", **kw)
                st = ref_init_state(jp, jax.random.PRNGKey(0), jhp, channel,
                                    algo)
                rf = jax.jit(ref_make_round_fn(algo, jp, jhp, channel))
                for _ in range(2):
                    st, _ = rf(st)
                ref_new, ref_m = rf(st)
                scaffold = algo in ("scaffold", "fedosaa_scaffold")
                start = convert.server_state(
                    st.params, st.t, st.comm, c=st.c if scaffold else None,
                    c_k=st.c_k if scaffold else None, device="cpu")
                draws = None
                if channel == "int8":
                    draws = {s.tag: reference_uniforms(st.rng, s.fold, d)
                             for s in UPLINK_SCHEMAS[algo]}
                rounds[name] = (algo, channel, kw, None, None, start, draws)
                want[name] = dict(ref=jax.tree.map(np.asarray, ref_new),
                                  ref_loss=float(ref_m.loss))
    finally:
        jax.config.update("jax_enable_x64", was)
    for name, algo, channel, kw, plan, gate in OWN:
        hp = AlgoHParams(**HP, **kw)
        fp = FaultPlan(**plan) if plan else None
        ag = AsyncConfig(**gate) if gate else None
        rounds[name] = (algo, channel, kw, plan, gate,
                        run_state(pp, algo, hp, channel, fp, ag, 2), None)
    for name, (algo, channel, kw, plan, gate, start, draws) in rounds.items():
        rf = make_round_fn(algo, pp, AlgoHParams(**HP, **kw), channel,
                           device="cpu",
                           faults=FaultPlan(**plan) if plan else None,
                           async_cfg=AsyncConfig(**gate) if gate else None)
        want.setdefault(name, {})["vmap"] = rf(start, draws)[0]

    svrg = dict(algo="fedosaa_svrg", hp=HP, channel="int8", plan=MIXED,
                gate=GATE, num_rounds=6)
    scaffold = dict(algo="fedosaa_scaffold", hp=HP, channel="int8",
                    plan=None, gate=None, num_rounds=6)
    target = dict(algo="fedosaa_svrg", hp=HP, channel=None, plan=None,
                  gate=None, num_rounds=TARGET_ROUNDS)
    runs = {"svrg_loop": (svrg, None), "svrg_engine": (svrg, 3),
            "scaffold_loop": (scaffold, None),
            "scaffold_engine": (scaffold, 3), "target": (target, None)}
    want["target"] = run_federated(pp, "fedosaa_svrg", AlgoHParams(**HP),
                                   TARGET_ROUNDS, device="cpu")
    ckpt_dir = str(base / "ckpt_w2")
    torch.save(dict(rounds=rounds, runs=runs, ckpt_dir=ckpt_dir,
                    ref_ckpt=dict(dir=ref_dir, algo="fedosaa_svrg",
                                  channel="int8", hp=CKPT_HP,
                                  faults=CKPT_PLAN, gate=GATE)),
               base / "inputs.pt")
    return dict(base=base, want=want, ckpt_dir=ckpt_dir, ref_dir=ref_dir,
                ref_ckpt_state=ref_ckpt_state)


def spawn(base: Path, world: int) -> list:
    """Run every case of a ``world``-rank world in one spawn; each rank's
    results."""
    from repro_torch.core.sharded import spawn_world

    workdir = base / f"w{world}"
    workdir.mkdir()
    # one intra-op thread a rank: the ranks share the host's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    results = spawn_world([sys.executable, str(Path(__file__).resolve()),
                           str(workdir)], world, str(workdir / "store"),
                          timeout_s=SPAWN_TIMEOUT, env=env, cwd=str(ROOT))
    for r, res in enumerate(results):
        assert res.returncode == 0, f"rank {r}: {res.stdout[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def world2(inputs):
    return spawn(inputs["base"], 2)


@pytest.fixture(scope="module")
def world4(inputs, world2):
    # the W = 4 world restores the W = 2 world's checkpoint
    return spawn(inputs["base"], 4)


@pytest.fixture(params=[2, 4], ids=["W2", "W4"])
def world(request):
    return request.getfixturevalue(f"world{request.param}")


def assert_states_close(got, want, tol: float = 1e-7):
    """Every tensor of two states (same fields, same comm keys) within
    ``tol`` of its scale: ‖w‖ for the params, max(‖w‖, max|x|) else."""
    from repro_torch.checkpoint.sharded_ckpt import _leaf_keys

    w_norm = float(torch.linalg.vector_norm(want.params))
    dw = float(torch.linalg.vector_norm(got.params - want.params)) / w_norm
    assert dw <= tol, dw
    assert got.t == want.t
    lg, lw = _leaf_keys(got), _leaf_keys(want)
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (key, a), (_, b) in zip(lg, lw):
        if not isinstance(a, torch.Tensor):
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if not a.dtype.is_floating_point:
            assert torch.equal(a, b), key
            continue
        scale = max(w_norm, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol * scale, key


@pytest.mark.parametrize("name", [f[0] for f in FAMILY])
def test_family_round_matches_vmap_and_reference(inputs, world, name):
    """One round from the reference's state, each rank its rows: every
    state tensor within 1e-7 of the vmap round's; the params within 1e-7
    and the loss within rel 1e-12 of the reference's, its wire buffers
    and control variates within 1e-7 of their scale."""
    from repro_torch.core import convert

    new = joined([r["rounds"][name]["state"] for r in world])
    assert all(r["rounds"][name]["same"] for r in world)
    want = inputs["want"][name]
    assert_states_close(new, want["vmap"])
    ref = want["ref"]
    scaffold = name == "fedosaa_scaffold"
    assert_states_close(new, convert.server_state(
        ref.params, ref.t, ref.comm, c=ref.c if scaffold else None,
        c_k=ref.c_k if scaffold else None, device="cpu"))
    for r in world:
        np.testing.assert_allclose(r["rounds"][name]["loss"],
                                   want["ref_loss"], rtol=1e-12)


@pytest.mark.parametrize("name", [o[0] for o in OWN])
def test_own_draw_round_matches_vmap(inputs, world, name):
    """Faults and the gate, the history poison, carried columns with
    minibatch steps: one round from the vmap runtime's state after two
    rounds, on the round's own draws, within 1e-7 of the vmap round on
    every state tensor (the ages and other int tensors exactly)."""
    new = joined([r["rounds"][name]["state"] for r in world])
    assert all(r["rounds"][name]["same"] for r in world)
    assert_states_close(new, inputs["want"][name]["vmap"])


HISTORY_FIELDS = ("rounds", "loss", "grad_norm", "rel_error", "theta_mean",
                  "comm_bytes", "gram_cond_max", "arrivals", "staleness_mean",
                  "staleness_max")


@pytest.mark.parametrize("algo", ["svrg", "scaffold"])
def test_engine_equals_loop(world, algo):
    """The engine's chunks of 3 (eager on the CPU) give the loop's History
    and final params bit for bit, on every rank, and every rank the same
    (FedOSAA-SVRG with every fault kind behind the gate; FedOSAA-SCAFFOLD),
    on int8."""
    for r in world:
        loop, eng = (r["runs"][f"{algo}_{p}"]["h"] for p in ("loop", "engine"))
        assert len(loop.rounds) == 6
        for f in HISTORY_FIELDS:
            np.testing.assert_array_equal(getattr(eng, f), getattr(loop, f),
                                          err_msg=f)
        assert torch.equal(eng.final_params, loop.final_params)
        for f in HISTORY_FIELDS:
            np.testing.assert_array_equal(
                getattr(loop, f), getattr(world[0]["runs"][f"{algo}_loop"]["h"],
                                          f), err_msg=f)


def test_rounds_to_target_within_one_round(inputs, world):
    """FedOSAA-SVRG to ‖∇f‖ < 1e-4 (about round 21 of this problem's
    linear rate): the ranks' run takes the vmap run's rounds within one."""
    def to_target(h):
        hit = np.nonzero(h.grad_norm < TARGET_GRAD_NORM)[0]
        assert len(hit), h.grad_norm
        return int(hit[0]) + 1

    want = to_target(inputs["want"]["target"])
    for r in world:
        assert abs(to_target(r["runs"]["target"]["h"]) - want) <= 1


def test_ranks_params_bit_equal(world):
    """After every round and run, the replicated params are the same bits on
    every rank (one all-gather each)."""
    for r in world:
        assert all(v["same"] for v in r["rounds"].values())
        assert all(v["same"] for v in r["runs"].values())


def test_resume_from_per_rank_shards(inputs, world2):
    """W = 2, a save every 2 rounds (async, one shard file per rank, rank
    0's manifest after the barrier): the run resumed from the first save
    gives the straight run's rows from round 2 on and its final params bit
    for bit; every checkpoint names both files and passes the reference's
    verify_checkpoint (the ranks' boxes tile each leaf)."""
    import json

    from repro.checkpoint import verify_checkpoint as ref_verify

    for r in world2:
        straight, resumed = r["ckpt"]["straight"], r["ckpt"]["resumed"]
        assert list(resumed.rounds) == list(range(2, CKPT_ROUNDS))
        for f in HISTORY_FIELDS[1:]:
            a, b = getattr(resumed, f), getattr(straight, f)[2:]
            if f == "comm_bytes":   # cumulative from the resume round
                a, b = np.diff(a), np.diff(b)
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert torch.equal(resumed.final_params, straight.final_params)
    d = inputs["ckpt_dir"]
    names = sorted(n for n in os.listdir(d) if n.startswith("ckpt_"))
    assert names == ["ckpt_00000002", "ckpt_00000004", "ckpt_00000006"]
    for n in names:
        path = os.path.join(d, n)
        manifest = json.loads(Path(path, "manifest.json").read_text())
        assert manifest["files"] == ["shards_p0000.npz", "shards_p0001.npz"]
        assert manifest["processes"] == 2
        assert manifest["config"]["runtime"] == "sharded"
        assert sorted(os.listdir(path)) == ["manifest.json",
                                            "shards_p0000.npz",
                                            "shards_p0001.npz"]
        assert ref_verify(path) is not None, path


def test_w2_checkpoint_restores_at_w4(inputs, world4):
    """A W = 4 world restores the W = 2 world's round-4 checkpoint: each
    rank's rows of every tensor are the saved rows bit for bit."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.robust import AsyncConfig, FaultPlan
    from repro_torch.core import AlgoHParams

    template = run_state(port_problem(), "fedosaa_svrg",
                         AlgoHParams(**CKPT_HP), "int8",
                         FaultPlan(**CKPT_PLAN), AsyncConfig(**GATE), 0)
    full, manifest = load_checkpoint(
        os.path.join(inputs["ckpt_dir"], "ckpt_00000004"), template)
    assert manifest["round"] == 4 and full.t == 4
    from repro_torch.checkpoint.sharded_ckpt import _leaf_keys

    got = joined([r["restore"] for r in world4])
    for (key, a), (_, b) in zip(_leaf_keys(got), _leaf_keys(full)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        else:
            assert a == b, key


def test_reference_sharded_checkpoint_restores_into_w2(inputs, world2):
    """The reference's sharded-runtime checkpoint (its fingerprint's
    runtime "sharded") restores into W = 2: each rank's rows are those of
    convert.server_state of the reference's restored state, bit for bit."""
    from repro_torch.checkpoint.sharded_ckpt import _leaf_keys
    from repro_torch.core import convert

    ref = inputs["ref_ckpt_state"]
    want = convert.server_state(ref.params, ref.t, ref.comm,
                                hist_s=ref.hist_s, hist_y=ref.hist_y,
                                device="cpu")
    got = joined([r["ref_restore"] for r in world2])
    assert got.t == 2
    for (key, a), (_, b) in zip(_leaf_keys(got), _leaf_keys(want)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), key


def test_k_that_does_not_divide_refuses(world4):
    """K = 6 over 4 ranks: client_shard and make_sharded_round_fn refuse."""
    for r in world4:
        assert "num_clients=6 does not divide over 4" in r["refusal"]
        assert "num_clients=6 does not divide over 4" in r["round_refusal"]


if __name__ == "__main__":
    child(Path(sys.argv[1]))
    sys.exit(0)
