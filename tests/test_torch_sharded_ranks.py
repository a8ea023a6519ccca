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

And on a cohort of C=4 of the K=8 clients (each rank computes C/W slots,
whose rows client_store.RowExchange moves in from their owners and back):

  * one round of each family from the reference's sharded cohort state,
    fed its cohort indices and uniforms (each rank its slots' rows), within
    1e-7 of the port's vmap cohort round and of the reference's sharded
    cohort round (its make_sharded_round_fn on make_host_mesh(), f64
    helpers); the rows of clients outside the cohort bit-equal to the
    start's;
  * every fault kind behind the gate on a cohort, within 1e-7 of the vmap
    cohort round; each rank's draws are the vmap round's rows of its slots
    (the cohort and the fault scalars whole);
  * C = K is the dense sharded round bit for bit;
  * the engine equals the loop bit for bit;
  * a cohort run saving every 2 rounds, one shard file per rank, and the
    run resumed from its first save end bit for bit, at W = 2 and W = 4;
  * C = 6 of 8 over 4 ranks refuses;
  * the reference's acceptance point of cohorts (K=4096, C=16, f32,
    FedOSAA-SVRG, eta 0.5, L=2, by the engine in chunks of 4, 8 rounds) at
    W = 4 takes the global loss below 0.7 of its initial value.
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
#: the cohort the cohort cases draw, of the K clients
C = 4
COHORT_KW = {"cohort_size": C}
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
        dict(carry_history=2, batch_size=16), None, None),
       ("cohort_mixed_gate", "fedosaa_svrg", "int8", COHORT_KW, MIXED, GATE),
       ("cohort_carry_minibatch", "fedosaa_svrg", "int8",
        dict(carry_history=2, batch_size=16, **COHORT_KW), None, None))
#: the cohort rounds from the reference's cohort state: FAMILY's cases,
#: each on a cohort. DANE takes the cohort tests' 2 Newton steps of 5 CG
#: iterations (tests/test_torch_cohort.py, the reference's own tests'): at
#: 3 of 10 its CG carries the ranks' summation order to 1.0e-7 of ‖w‖ at
#: W = 2 (the port's vmap cohort round is at 6.3e-8 of the reference's)
SMALL_DANE = dict(dane_newton_iters=2, dane_cg_iters=5)
COHORT_FAMILY = tuple(
    (f"cohort_{name}", algo, channel,
     {**(SMALL_DANE if algo == "dane" else kw), **COHORT_KW})
    for name, algo, channel, kw in FAMILY)
#: the cohort cases whose round carries per-client rows (SCAFFOLD's c_k, the
#: int8 wire's buffers): the reference's sharded cohort round cannot write
#: them back on this JAX (its _commit_plan's scatter into the K-sized store
#: raises ShardingTypeError under the mesh), so these are held against its
#: vmap cohort round, which its sharded round equals where it runs
#: (ROADMAP.md §3)
REF_VMAP_COHORT = ("cohort_fedosaa_scaffold", "cohort_fedosaa_svrg_int8")
#: the cohort cases whose identity cohort (C = K) is held against the dense
#: sharded round: (case, algorithm, channel, fault plan, gate)
IDENTITY = (("svrg_mixed_gate", "fedosaa_svrg", "int8", MIXED, GATE),
            ("scaffold_int8", "fedosaa_scaffold", "int8", None, None))
#: the reference's acceptance point of cohorts (tests/test_cohort.py's
#: test_k4096_engine_run_converges; benchmarks/ext_cohort.py): K clients of
#: synthetic_small with 8 rows each, float32, a cohort of BIG_C, by the
#: engine in chunks of BIG_CHUNK for BIG_ROUNDS rounds; the global loss ends
#: below BIG_LOSS_SHARE of its initial value
BIG_K, BIG_C, BIG_CHUNK, BIG_ROUNDS, BIG_LOSS_SHARE = 4096, 16, 4, 8, 0.7
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
def big_cohort_run() -> dict:
    """The acceptance point of cohorts on this rank of the world: the
    global loss before and after the engine's BIG_ROUNDS rounds."""
    from repro_torch.core import AlgoHParams, init_state, run_rounds
    from repro_torch.core.sharded import make_sharded_round_fn
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem

    X, y = make_binary_classification("synthetic_small", n=8 * BIG_K, seed=0)
    prob = make_logreg_problem(partition(X, y, BIG_K, "iid", seed=0,
                                         device="cpu"), 1e-3, device="cpu")
    rf = make_sharded_round_fn("fedosaa_svrg", prob,
                               AlgoHParams(eta=0.5, local_epochs=2,
                                           cohort_size=BIG_C), device="cpu")
    state = init_state(rf.rank_problem, device="cpu")
    loss0 = float(prob.global_loss(state.params))
    state, trace = run_rounds(rf, state, BIG_ROUNDS, chunk=BIG_CHUNK)
    return dict(loss0=loss0, loss=float(prob.global_loss(state.params)),
                rounds=trace.num_rounds, params=state.params)


def child(workdir: Path) -> None:
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint import (CheckpointPolicy, load_checkpoint,
                                        load_latest)
    from repro_torch.comm import make_channel
    from repro_torch.core import AlgoHParams, make_round_fn, run_federated
    from repro_torch.core.algorithms import COHORT
    from repro_torch.core.engine import _tensors
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
    # this rank's slots of a cohort
    slots = slice(rank * C // W, (rank + 1) * C // W)
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
        mine = slots if "cohort_size" in kw else sl
        d = None if draws is None else {
            n: v if n == COHORT else v[mine] for n, v in draws.items()}
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

    if W == 2:
        # the svrg engine run again with a live tap: only rank 0 taps
        from repro_torch.obs import LiveTap

        kw = dict(inp["runs"]["svrg_engine"][0])
        hp = AlgoHParams(**kw.pop("hp"))
        plan, gate = kw.pop("plan"), kw.pop("gate")
        tap = LiveTap()
        h = run_federated(prob, hp=hp, device="cpu", chunk=3,
                          runtime="sharded", faults=FaultPlan(**plan),
                          async_cfg=AsyncConfig(**gate), tap=tap, **kw)
        out["tap"] = dict(rows=tap.rows, h=h)

    # a cohort round's draws: the vmap round's, the rank's slots' rows
    hp = AlgoHParams(**HP, batch_size=16, **COHORT_KW)
    plan, gate = FaultPlan(**MIXED), AsyncConfig(**GATE)
    vm = make_round_fn("fedosaa_svrg", prob, hp, "int8", device="cpu",
                       faults=plan, async_cfg=gate)
    rf = make_sharded_round_fn("fedosaa_svrg", prob, hp, channel="int8",
                               device="cpu", faults=plan, async_cfg=gate)
    bufs = {}
    for f in (vm, rf):
        bufs[f] = {n: torch.empty((2, *sh), dtype=dt)
                   for n, (sh, dt) in f.draw_specs.items()}
        f.fill_draws(bufs[f], 3)
    whole = (COHORT, "fault.drop", "fault.stale", "fault.latency")
    out["draws"] = {n: torch.equal(b, bufs[vm][n] if n in whole
                                   else bufs[vm][n][:, slots])
                    for n, b in bufs[rf].items()}

    # the identity cohort against the dense sharded round
    out["identity"] = {}
    for name, algo, channel, plan, gate in IDENTITY:
        plan = FaultPlan(**plan) if plan else None
        gate = AsyncConfig(**gate) if gate else None
        hp = AlgoHParams(**HP)
        dense = make_sharded_round_fn(algo, prob, hp, channel=channel,
                                      device="cpu", faults=plan,
                                      async_cfg=gate)
        ident = make_sharded_round_fn(
            algo, prob, dataclasses.replace(hp, cohort_size=K),
            channel=channel, device="cpu", faults=plan, async_cfg=gate)
        a = b = rows_of(run_state(prob, algo, hp, channel, plan, gate, 2), sl)
        equal = True
        for _ in range(2):
            a, _ = dense(a)
            b, _ = ident(b)
            equal &= all(torch.equal(x, y)
                         for x, y in zip(_tensors(a), _tensors(b)))
        out["identity"][name] = equal

    ckpt = dict(hp=AlgoHParams(**CKPT_HP), channel="int8",
                faults=FaultPlan(**CKPT_PLAN), async_cfg=AsyncConfig(**GATE))
    shard = client_shard(K)
    # a cohort run, saving every 2 rounds, and the run resumed from its
    # first save
    d = f"{inp['ckpt_dir']}_cohort_w{W}"
    kw = {**ckpt, "hp": AlgoHParams(**CKPT_HP, **COHORT_KW)}
    pol = CheckpointPolicy(directory=d, every=2, keep=0, mode="async")
    straight = run_federated(prob, "fedosaa_svrg", num_rounds=CKPT_ROUNDS,
                             device="cpu", runtime="sharded", checkpoint=pol,
                             **kw)
    resumed = run_federated(prob, "fedosaa_svrg", num_rounds=CKPT_ROUNDS,
                            device="cpu", runtime="sharded",
                            resume=os.path.join(d, "ckpt_00000002"), **kw)
    out["cohort_ckpt"] = dict(straight=straight, resumed=resumed, dir=d)
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
        try:
            make_sharded_round_fn("fedosaa_svrg", prob,
                                  AlgoHParams(**HP, cohort_size=6),
                                  device="cpu")
        except ValueError as e:
            out["cohort_refusal"] = str(e)
        out["big"] = big_cohort_run()
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests' side
# ---------------------------------------------------------------------------
def reference_uniforms(rng, fold: int, d: int, chunk: int = 256,
                       rows=None):
    """The reference's int8 uniforms of uplink ``fold`` for every client of
    the round that starts from key ``rng`` (tests/test_torch_round.py), or
    for the clients ``rows``."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    nc = -(-d // chunk)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(keys[k], fold), 0),
        (nc, chunk), jnp.float32)) for k in (range(K) if rows is None
                                             else rows)]))


def reference_cohort_draws(jp, rng, algo: str, channel, d: int) -> dict:
    """The reference's draws of the cohort round keyed by ``rng``: its
    cohort (``_sample_cohort`` on the round's participation key; its vmap
    and sharded rounds draw the same) and, on int8, each uplink's uniforms
    at the cohort's rows (tests/test_torch_cohort.py)."""
    import jax

    from repro.core import algorithms as ref_algos
    from repro_torch.core import UPLINK_SCHEMAS
    from repro_torch.core.algorithms import COHORT

    idx, _ = ref_algos._sample_cohort(jp.clients.weight, C,
                                      jax.random.split(rng, 3)[1])
    idx = np.asarray(idx).astype(np.int64)
    draws = {COHORT: torch.from_numpy(idx)}
    if channel == "int8":
        for s in UPLINK_SCHEMAS[algo]:
            draws[s.tag] = reference_uniforms(rng, s.fold, d, rows=idx)
    return draws


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
    from repro.core.sharded import make_sharded_round_fn as ref_sharded
    from repro.data import make_binary_classification as ref_make
    from repro.launch.mesh import make_host_mesh
    from repro.data import partition as ref_partition
    from repro.models.logreg import make_logreg_problem as ref_problem
    from repro.robust import AsyncConfig as RefGate
    from repro.robust import FaultPlan as RefPlan
    from repro.robust import init_async_comm as ref_async
    from repro.robust import init_fault_comm as ref_fault
    from repro_torch.core import (UPLINK_SCHEMAS, AlgoHParams, convert,
                                  make_round_fn, run_federated)
    from repro_torch.core.algorithms import COHORT
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
            # the reference's sharded cohort rounds on its host mesh (its
            # vmap cohort rounds where the sharded one cannot run)
            mesh = make_host_mesh()
            for name, algo, channel, kw in COHORT_FAMILY:
                jhp = RefHP(**HP, aa_impl="tree", local_impl="tree", **kw)
                st = ref_init_state(jp, jax.random.PRNGKey(0), jhp, channel,
                                    algo)
                rf = jax.jit(
                    ref_make_round_fn(algo, jp, jhp, channel)
                    if name in REF_VMAP_COHORT else
                    ref_sharded(algo, jp, jhp, mesh, channel=channel))
                for _ in range(2):
                    st, _ = rf(st)
                ref_new, ref_m = rf(st)
                scaffold = algo in ("scaffold", "fedosaa_scaffold")
                start = convert.server_state(
                    st.params, st.t, st.comm, c=st.c if scaffold else None,
                    c_k=st.c_k if scaffold else None, device="cpu")
                draws = reference_cohort_draws(jp, st.rng, algo, channel, d)
                rounds[name] = (algo, channel, kw, None, None, start, draws)
                want[name] = dict(ref=jax.tree.map(np.asarray, ref_new),
                                  ref_loss=float(ref_m.loss), start=start,
                                  idx=draws[COHORT])
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
    cohort_svrg = {**svrg, "hp": {**HP, **COHORT_KW}}
    cohort_scaffold = {**scaffold, "hp": {**HP, **COHORT_KW}}
    target = dict(algo="fedosaa_svrg", hp=HP, channel=None, plan=None,
                  gate=None, num_rounds=TARGET_ROUNDS)
    runs = {"svrg_loop": (svrg, None), "svrg_engine": (svrg, 3),
            "scaffold_loop": (scaffold, None),
            "scaffold_engine": (scaffold, 3), "target": (target, None),
            "cohort_svrg_loop": (cohort_svrg, None),
            "cohort_svrg_engine": (cohort_svrg, 3),
            "cohort_scaffold_loop": (cohort_scaffold, None),
            "cohort_scaffold_engine": (cohort_scaffold, 3)}
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


def cohort_rows_frozen(new, start, idx) -> None:
    """The rows of the clients outside the cohort ``idx``, of every
    per-client tensor, are the start's bit for bit."""
    from repro_torch.core.client_store import ClientStateStore, flat_leaves

    off = torch.tensor(sorted(set(range(K)) - set(idx.tolist())))
    a, b = (flat_leaves(ClientStateStore.from_state(s)) for s in (new, start))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.index_select(0, off), y.index_select(0, off))


@pytest.mark.parametrize("name", [f[0] for f in COHORT_FAMILY])
def test_cohort_family_round_matches_vmap_and_reference(inputs, world, name):
    """One cohort round (C=4 of 8) from the reference's sharded cohort
    state, fed its cohort and uniforms, each rank its slots' rows: every
    state tensor within 1e-7 of the port's vmap cohort round and of the
    reference's sharded cohort round (its vmap cohort round for
    REF_VMAP_COHORT), the loss within rel 1e-9 of the reference's; the
    rows of the clients outside the cohort as they were."""
    from repro_torch.core import convert

    new = joined([r["rounds"][name]["state"] for r in world])
    assert all(r["rounds"][name]["same"] for r in world)
    want = inputs["want"][name]
    assert_states_close(new, want["vmap"])
    ref = want["ref"]
    scaffold = "scaffold" in name
    assert_states_close(new, convert.server_state(
        ref.params, ref.t, ref.comm, c=ref.c if scaffold else None,
        c_k=ref.c_k if scaffold else None, device="cpu"))
    cohort_rows_frozen(new, want["start"], want["idx"])
    for r in world:
        np.testing.assert_allclose(r["rounds"][name]["loss"],
                                   want["ref_loss"], rtol=1e-9)


def test_cohort_draws_are_the_vmap_rows_of_the_slots(world):
    """A cohort round's draws (int8 uniforms, minibatch rows, every fault
    draw) on each rank: the vmap round's rows of its slots, and the cohort
    and the fault scalars whole."""
    for r in world:
        assert r["draws"] and all(r["draws"].values()), r["draws"]


@pytest.mark.parametrize("name", [i[0] for i in IDENTITY])
def test_identity_cohort_is_the_dense_sharded_round(world, name):
    """C = K: every slot is the client its rank owns; two rounds are the
    dense sharded round's bit for bit on every rank."""
    assert all(r["identity"][name] for r in world)


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


@pytest.mark.parametrize("algo", ["svrg", "scaffold", "cohort_svrg",
                                  "cohort_scaffold"])
def test_engine_equals_loop(world, algo):
    """The engine's chunks of 3 (eager on the CPU) give the loop's History
    and final params bit for bit, on every rank, and every rank the same
    (FedOSAA-SVRG with every fault kind behind the gate; FedOSAA-SCAFFOLD),
    on int8, dense and on a cohort of C=4."""
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


def test_only_rank_zero_taps(world2):
    """run_federated(runtime="sharded", chunk=3, tap=LiveTap()) over W = 2
    (FedOSAA-SVRG with every fault kind behind the gate, int8): rank 0's
    tap gets one row per round, slots 0-2 twice, each its History's row;
    rank 1's tap gets none; the tapped run is the tapless engine run bit
    for bit on both ranks."""
    rows = world2[0]["tap"]["rows"]
    assert world2[1]["tap"]["rows"] == []
    h = world2[0]["tap"]["h"]
    assert [r["slot"] for r in rows] == [0, 1, 2, 0, 1, 2]
    for f in ("loss", "grad_norm", "rel_error", "theta_mean", "arrivals",
              "staleness_mean", "staleness_max"):
        np.testing.assert_array_equal([r[f] for r in rows], getattr(h, f),
                                      err_msg=f)
    for r in world2:
        tapped, plain = r["tap"]["h"], r["runs"]["svrg_engine"]["h"]
        for f in HISTORY_FIELDS:
            np.testing.assert_array_equal(getattr(tapped, f),
                                          getattr(plain, f), err_msg=f)
        assert torch.equal(tapped.final_params, plain.final_params)


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


def test_cohort_resume_from_per_rank_shards(world):
    """A cohort run (C=4 of 8) saving every 2 rounds, one shard file per
    rank, each holding the rank's K/W store rows, and the run resumed from
    its first save: the straight run's rows from round 2 on and its final
    params bit for bit."""
    import json

    W = len(world)
    for r in world:
        straight, resumed = (r["cohort_ckpt"][k] for k in ("straight",
                                                           "resumed"))
        assert list(resumed.rounds) == list(range(2, CKPT_ROUNDS))
        for f in HISTORY_FIELDS[1:]:
            a, b = getattr(resumed, f), getattr(straight, f)[2:]
            if f == "comm_bytes":
                a, b = np.diff(a), np.diff(b)
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert torch.equal(resumed.final_params, straight.final_params)
    path = os.path.join(world[0]["cohort_ckpt"]["dir"], "ckpt_00000002")
    manifest = json.loads(Path(path, "manifest.json").read_text())
    assert manifest["files"] == [f"shards_p{i:04d}.npz" for i in range(W)]
    assert manifest["config"]["cohort_size"] == C
    boxes = [sm["box"][0] for sm in
             manifest["leaves"][".comm/__async_age__"]["shards"]]
    assert sorted(boxes) == [[r * K // W, (r + 1) * K // W]
                             for r in range(W)]


def test_cohort_that_does_not_divide_refuses(world4):
    """C = 6 of K = 8 over 4 ranks: make_sharded_round_fn refuses, in the
    reference's words."""
    for r in world4:
        assert ("cohort_size=6 does not divide over 4 client shards"
                in r["cohort_refusal"])


def test_k4096_cohort_engine_run_converges(world4):
    """K=4096, C=16 (4 slots a rank), f32, by the engine at W = 4: the
    global loss ends below 0.7 of its initial value, the params the same on
    every rank."""
    for r in world4:
        big = r["big"]
        assert big["rounds"] == BIG_ROUNDS
        assert big["loss"] < BIG_LOSS_SHARE * big["loss0"], big
        assert torch.equal(big["params"], world4[0]["big"]["params"])


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
