"""The port's checkpoint protocol (repro_torch/checkpoint and
robust/fs_faults), case for case the classes of
tests/test_checkpoint_preempt.py on the port.

A process killed at ANY byte of a save leaves the directory in a state from
which ``load_latest`` restores the newest complete checkpoint bit for bit:
torn temp directories are invisible to discovery, corrupt or partial
checkpoints are skipped (never raised on), a full disk degrades the run
instead of crashing it, a second save due while one is in flight waits and
warns, and the legacy npz save is atomic. The manifest names the reference's
leaf keys and says what rode along. Fault realizations are deterministic
(FSFaultPlan is keyed, not random), so every scenario replays bit for bit.
"""
import json
import os
import sys
import threading

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, strategies as st

from repro_torch.checkpoint import (CheckpointConfigMismatch,
                                    CheckpointManager, CheckpointPolicy,
                                    ckpt_name, latest_step, list_checkpoints,
                                    load_checkpoint, load_latest,
                                    prune_checkpoints, restore_checkpoint,
                                    save_checkpoint, snapshot_shards,
                                    write_bytes_atomic, write_checkpoint)
from repro_torch.checkpoint.policy import MODES
from repro_torch.checkpoint.sharded_ckpt import _leaf_keys
from repro_torch.core import (AAConfig, AlgoHParams, init_state,
                              make_round_fn, run_rounds)
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.obs import MemorySink
from repro_torch.robust import (KILL_EXIT_CODE, FaultyFs, FSFaultPlan,
                                SimulatedKill, init_async_comm)

K = 8


@pytest.fixture(scope="module")
def prob():
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    clients = partition(X, y, K, "iid", seed=0, device="cpu")
    return make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")


def _tiny_state():
    """A cheap tree standing in for ServerState where the protocol, not the
    algorithm, is under test: an f32 matrix, an int round counter, a nested
    dict buffer."""
    return {
        "w": torch.arange(24.0, dtype=torch.float32).reshape(4, 6),
        "t": 3,
        "comm": {"int8/ef": torch.ones(8)},
    }


def _save(directory, round_idx, state=None, fs=None, config=None):
    snap = snapshot_shards(state if state is not None else _tiny_state())
    kw = {} if fs is None else {"fs": fs}
    return write_checkpoint(directory, snap, round_idx,
                            config=config or {}, **kw)


def _corrupt(path: str, kind: str) -> None:
    """Turn a COMMITTED checkpoint into each defect class the recovery
    property quantifies over."""
    manifest = os.path.join(path, "manifest.json")
    if kind == "none":
        return
    if kind == "torn_manifest":
        data = open(manifest, "rb").read()
        with open(manifest, "wb") as f:
            f.write(data[: len(data) // 2])
    elif kind == "bad_digest":
        m = json.load(open(manifest))
        first = next(iter(m["leaves"].values()))
        first["shards"][0]["sha256"] = "0" * 64
        with open(manifest, "w") as f:
            json.dump(m, f)
    elif kind == "missing_shard":
        for name in os.listdir(path):
            if name.startswith("shards_"):
                os.remove(os.path.join(path, name))
    elif kind == "empty":
        for name in os.listdir(path):
            os.remove(os.path.join(path, name))
    else:  # pragma: no cover
        raise ValueError(kind)


class TestAtomicCommit:
    def test_kill_mid_save_leaves_torn_tmp_invisible(self, tmp_path):
        d = str(tmp_path)
        fs = FaultyFs(FSFaultPlan(kill_at_save=1, kill_after_writes=1))
        fs.on_save_start()
        with pytest.raises(SimulatedKill):
            _save(d, 5, fs=fs)
        remnants = [n for n in os.listdir(d) if n.startswith(".tmp-")]
        assert remnants, "the kill must leave the torn staging dir behind"
        assert list_checkpoints(d) == []
        assert load_latest(d, _tiny_state()) is None

    def test_kill_before_commit_rename(self, tmp_path):
        """Every shard and the manifest staged, death before the directory
        rename: the checkpoint never existed."""
        d = str(tmp_path)
        fs = FaultyFs(FSFaultPlan(kill_at_save=1, kill_after_writes=2))
        fs.on_save_start()
        with pytest.raises(SimulatedKill):
            _save(d, 5, fs=fs)
        assert list_checkpoints(d) == []

    def test_torn_write_never_under_final_name(self, tmp_path):
        path = str(tmp_path / "blob.bin")
        fs = FaultyFs(FSFaultPlan(torn_write_rate=1.0))
        with pytest.raises(OSError):
            write_bytes_atomic(path, b"x" * 4096, fs=fs, retries=1,
                               backoff_s=0.0, sleep=lambda _: None)
        assert not os.path.exists(path)

    def test_transient_error_retried(self, tmp_path):
        d = str(tmp_path)
        fs = FaultyFs(FSFaultPlan(flaky_writes=(0,)))
        path, nbytes = write_checkpoint(
            d, snapshot_shards(_tiny_state()), 7, config={}, fs=fs,
            backoff_s=0.0, sleep=lambda _: None)
        assert list_checkpoints(d) == [(7, path)]
        assert nbytes > 0

    def test_retention_gc_and_tmp_sweep(self, tmp_path):
        d = str(tmp_path)
        for r in (2, 4, 6, 8):
            _save(d, r)
        os.makedirs(os.path.join(d, ".tmp-ckpt_00000010-999"))
        removed = prune_checkpoints(d, keep=2)
        assert [r for r, _ in list_checkpoints(d)] == [8, 6]
        assert any(".tmp-" in p for p in removed)
        assert not any(n.startswith(".tmp-") for n in os.listdir(d))

    def test_keep_zero_keeps_everything(self, tmp_path):
        d = str(tmp_path)
        for r in (1, 2, 3):
            _save(d, r)
        prune_checkpoints(d, keep=0)
        assert [r for r, _ in list_checkpoints(d)] == [3, 2, 1]

    def test_resave_same_round_overwrites(self, tmp_path):
        d = str(tmp_path)
        _save(d, 4)
        state = _tiny_state()
        state["w"] = state["w"] + 1.0
        _save(d, 4, state=state)
        tree, _ = load_latest(d, _tiny_state())
        assert torch.equal(tree["w"], state["w"])

    def test_kill_exit_code(self):
        assert KILL_EXIT_CODE == 43


class TestRecoveryProperty:
    """load_latest over ANY subset of {complete, torn-manifest, bad-digest,
    missing-shard, empty}: never raises, never selects an incomplete
    checkpoint, always lands on the newest complete one (or None)."""

    @settings(max_examples=30, deadline=None)
    @given(newest_kind=st.sampled_from(
               ["none", "torn_manifest", "bad_digest", "missing_shard",
                "empty"]),
           middle_kind=st.sampled_from(["none", "torn_manifest", "empty"]),
           oldest_ok=st.booleans())
    def test_skips_defective_selects_newest_complete(
            self, tmp_path_factory, newest_kind, middle_kind, oldest_ok):
        d = str(tmp_path_factory.mktemp("prop"))
        by_round = {}
        for r in (2, 4, 6):
            state = _tiny_state()
            state["w"] = state["w"] + float(r)
            state["t"] = r
            path, _ = _save(d, r, state=state)
            by_round[r] = (path, state)
        _corrupt(by_round[6][0], newest_kind)
        _corrupt(by_round[4][0], middle_kind)
        if not oldest_ok:
            _corrupt(by_round[2][0], "missing_shard")

        complete = [r for r, kind in ((6, newest_kind), (4, middle_kind),
                                      (2, "none" if oldest_ok else "empty"))
                    if kind == "none"]
        found = load_latest(d, _tiny_state())
        if not complete:
            assert found is None
        else:
            tree, manifest = found
            assert manifest["round"] == max(complete)
            want = by_round[max(complete)][1]
            assert torch.equal(tree["w"], want["w"])
            assert tree["t"] == want["t"] and type(tree["t"]) is int

    def test_garbage_directory_never_raises(self, tmp_path):
        d = str(tmp_path)
        open(os.path.join(d, "notes.txt"), "w").write("hi")
        os.makedirs(os.path.join(d, "ckpt_not_a_number"))
        os.makedirs(os.path.join(d, ckpt_name(3)))  # committed name, empty
        assert load_latest(d, _tiny_state()) is None
        assert list_checkpoints(d) == [(3, os.path.join(d, ckpt_name(3)))]

    def test_missing_directory_is_fresh_start(self, tmp_path):
        assert load_latest(str(tmp_path / "never_created"),
                           _tiny_state()) is None

    def test_config_mismatch_refuses(self, tmp_path):
        d = str(tmp_path)
        _save(d, 3, config={"algo": "fedosaa_svrg", "channel": "int8"})
        with pytest.raises(CheckpointConfigMismatch):
            load_latest(d, _tiny_state(),
                        expect_config={"algo": "fedosaa_svrg",
                                       "channel": "identity"})
        assert load_latest(
            d, _tiny_state(),
            expect_config={"algo": "fedosaa_svrg",
                           "channel": "int8"}) is not None
        # an explicitly named checkpoint refuses too, and raises when corrupt
        path = os.path.join(d, ckpt_name(3))
        with pytest.raises(CheckpointConfigMismatch):
            load_checkpoint(path, _tiny_state(),
                            expect_config={"channel": "identity"})
        _corrupt(path, "bad_digest")
        with pytest.raises(ValueError, match="incomplete or corrupt"):
            load_checkpoint(path, _tiny_state())

    def test_restore_keeps_dtype_device_and_ignores_extra_leaves(self,
                                                                 tmp_path):
        """Each leaf comes back in the template's dtype (bf16 stored as f32
        and cast back exactly); leaves the template lacks are ignored, a
        leaf it needs and the checkpoint lacks raises."""
        d = str(tmp_path)
        state = _tiny_state()
        state["h"] = torch.linspace(-3, 3, 7).to(torch.bfloat16)
        state["extra"] = torch.zeros(2)
        _save(d, 1, state=state)
        like = {k: v for k, v in _tiny_state().items()}
        like["h"] = torch.zeros(7, dtype=torch.bfloat16)
        tree, manifest = load_latest(d, like)
        assert "extra" not in tree
        assert tree["h"].dtype == torch.bfloat16
        assert torch.equal(tree["h"], state["h"])
        assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
        assert manifest["leaves"]["h"]["stored_dtype"] == "float32"
        with pytest.raises(KeyError, match="no leaf 'missing'"):
            load_latest(d, {**like, "missing": torch.zeros(1)})


class TestEnospcGracefulDegrade:
    def test_run_continues_failure_counted_next_save_clean(self, prob,
                                                           tmp_path):
        """A full disk during save 1: the run keeps training, the failure is
        counted and alarmed in the v4 footer, and save 2 commits."""
        hp = AlgoHParams(eta=0.5, local_epochs=3)
        rf = make_round_fn("fedosaa_svrg", prob, hp, device="cpu")
        state = init_state(prob, device="cpu", algo="fedosaa_svrg", hp=hp)
        d = str(tmp_path)
        # first save = write steps 0..3 (1 write + 3 retries), all ENOSPC;
        # the second save starts at step 4 and succeeds
        fs = FaultyFs(FSFaultPlan(enospc_writes=(0, 1, 2, 3)))
        mgr = CheckpointManager(
            CheckpointPolicy(directory=d, every=2, mode="sync",
                             backoff_s=0.0), fs=fs)
        sink = MemorySink()
        _, trace = run_rounds(rf, state, 4, chunk=2, sinks=[sink],
                              checkpoint=mgr)
        assert trace.num_rounds == 4, "the run must survive the full disk"
        assert mgr.telemetry()["checkpoint_failures"] == 1
        assert [e["rule"] for e in mgr.events] == ["checkpoint_failed"]
        assert sink.footer["checkpoint_failures"] == 1
        assert any(a["rule"] == "checkpoint_failed"
                   for a in sink.footer["alarms"])
        assert [r for r, _ in list_checkpoints(d, fs=fs)] == [4]
        assert not any(n.startswith(".tmp-") for n in os.listdir(d)), \
            "the failed save must sweep its staging dir"


class TestBackpressure:
    def test_one_in_flight_wait_and_warn(self, tmp_path):
        gate = threading.Event()

        class SlowFs(FaultyFs):
            def write_bytes(self, path, data):
                gate.wait(timeout=5.0)
                super().write_bytes(path, data)

        fs = SlowFs(FSFaultPlan())
        mgr = CheckpointManager(CheckpointPolicy(
            directory=str(tmp_path), every=1, mode="async"), fs=fs)
        state = _tiny_state()
        assert mgr.maybe_save(state, 1, 0.001)
        threading.Timer(0.05, gate.set).start()
        assert mgr.maybe_save(state, 2, 0.001)   # must wait, then dispatch
        mgr.finalize()
        assert "checkpoint_stalled" in [e["rule"] for e in mgr.events]
        assert mgr.saves_completed == 2
        assert [r for r, _ in list_checkpoints(str(tmp_path), fs=fs)] \
            == [2, 1]

    def test_many_async_saves_under_a_short_switch_interval(self, tmp_path):
        """Forty async saves, each due while the last may still write, with
        the interpreter switching threads every microsecond: every save
        commits once, the counters add up, no two writers overlap."""
        writing, overlaps = [0], []
        lock = threading.Lock()

        class WatchFs(FaultyFs):
            def write_bytes(self, path, data):
                with lock:
                    writing[0] += 1
                    overlaps.append(writing[0] > 1)
                super().write_bytes(path, data)
                with lock:
                    writing[0] -= 1

        fs = WatchFs(FSFaultPlan())
        mgr = CheckpointManager(CheckpointPolicy(
            directory=str(tmp_path), every=1, keep=0, mode="async"), fs=fs)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for r in range(1, 41):
                state = _tiny_state()
                state["t"] = r
                assert mgr.maybe_save(state, r, 0.0)
            worker = mgr._worker
            mgr.finalize()
        finally:
            sys.setswitchinterval(interval)
        assert worker is None or not worker.is_alive()
        assert mgr.saves_completed == 40 and not any(overlaps)
        assert len(list_checkpoints(str(tmp_path), fs=fs)) == 40
        assert mgr.telemetry()["checkpoint_failures"] == 0
        tree, manifest = load_latest(str(tmp_path), _tiny_state())
        assert manifest["round"] == 40 and tree["t"] == 40

    def test_policy_validates(self, tmp_path):
        assert MODES == ("async", "sync", "sync_gather")
        for bad in (dict(every=0), dict(keep=-1), dict(mode="later")):
            with pytest.raises(ValueError):
                CheckpointPolicy(directory=str(tmp_path), **bad)
        with pytest.raises(ValueError):
            FSFaultPlan(torn_write_rate=1.5)

    def test_sync_gather_saves_the_legacy_npz(self, tmp_path):
        """The baseline's save is the legacy npz of the whole state, and
        it calls the fault harness's save counter as every mode does."""
        fs = FaultyFs(FSFaultPlan())
        mgr = CheckpointManager(CheckpointPolicy(
            directory=str(tmp_path), every=1, mode="sync_gather"), fs=fs)
        assert mgr.maybe_save(_tiny_state(), 1, 0.01)
        mgr.finalize()
        assert fs.save_index == 1 and mgr.saves_completed == 1
        assert mgr.telemetry()["checkpoint_bytes"] > 0
        path = str(tmp_path / "sync_gather" / "state_00000001")
        tree = restore_checkpoint(path, like=_tiny_state())
        assert torch.equal(tree["w"], _tiny_state()["w"]) and tree["t"] == 3
        assert latest_step(str(tmp_path / "sync_gather")) == 1


class TestLegacyNpzAtomic:
    def test_interrupted_save_never_corrupts_existing(self, tmp_path):
        path = str(tmp_path / "legacy_state")
        tree = {"w": torch.arange(6.0)}
        save_checkpoint(path, tree, step=1)
        before = open(path + ".npz", "rb").read()
        fs = FaultyFs(FSFaultPlan(torn_write_rate=1.0))
        with pytest.raises(OSError):
            save_checkpoint(path, {"w": torch.zeros(6)}, step=2, fs=fs)
        assert open(path + ".npz", "rb").read() == before
        restored = restore_checkpoint(path, like={"w": torch.zeros(6)})
        assert torch.equal(restored["w"], tree["w"])

    def test_no_tmp_litter_on_success(self, tmp_path):
        save_checkpoint(str(tmp_path / "clean"), {"w": torch.ones(3)}, step=0)
        assert [n for n in os.listdir(tmp_path) if ".tmp-" in n] == []


#: the adversarial carried state: int8 EF residuals + diff refs, two AA
#: history columns, per-client async buffers and ages
RICH_HP = dict(eta=0.5, local_epochs=3, carry_history=2,
               aa=AAConfig(tikhonov=1e-6, damping=0.7))


class TestManifestInventory:
    def test_manifest_names_every_subsystem_buffer(self, prob, tmp_path):
        """The inventory accounts for the comm tags, the AA history and the
        async buffers; ``rng`` is false (the port has no PRNG key: its draws
        are keyed by the round counter, which is there). The leaf keys are
        the reference's for the same state, less its ``.rng`` and the
        control variates the port holds only for the SCAFFOLD family."""
        import jax

        from repro.comm import make_channel as ref_channel
        from repro.core import AlgoHParams as RefHP
        from repro.core import init_state as ref_init_state
        from repro.robust import init_async_comm as ref_async_comm
        from repro.data import make_binary_classification as ref_make
        from repro.data import partition as ref_partition
        from repro.models.logreg import make_logreg_problem as ref_problem

        hp = AlgoHParams(**RICH_HP)
        state = init_state(prob, device="cpu", channel="int8",
                           algo="fedosaa_svrg", hp=hp)
        state = state._replace(comm=init_async_comm(state.comm, state.params,
                                                    K))
        d = str(tmp_path)
        _save(d, 1, state=state)
        manifest = json.load(
            open(os.path.join(d, ckpt_name(1), "manifest.json")))
        inv = manifest["inventory"]
        assert inv["aa_history"] is True and inv["async_buffers"] is True
        assert inv["rng"] is False and inv["round_counter"] is True
        assert inv["comm_tags"] == ["__async_age__", "__async_buf__",
                                    "delta", "grad"]
        assert inv["num_leaves"] == len(_leaf_keys(state))
        assert manifest["leaves"][".t"]["dtype"] == "int32"
        assert manifest["leaves"][".comm/__async_age__"]["dtype"] == "int32"
        for leaf in manifest["leaves"].values():
            for sh in leaf["shards"]:
                assert len(sh["sha256"]) == 64

        X, y = ref_make("synthetic_small", n=400, seed=0)
        rprob = ref_problem(ref_partition(X, y, num_clients=K, scheme="iid"),
                            gamma=1e-3)
        ch = ref_channel("int8")
        ref = ref_init_state(rprob, jax.random.PRNGKey(0),
                             RefHP(local_epochs=3, carry_history=2), ch,
                             "fedosaa_svrg")
        ref = ref._replace(comm=ref_async_comm(ref.comm, ref.params, K))
        ref_keys = {"/".join(k.key if hasattr(k, "key") else str(k)
                             for k in kp)
                    for kp, _ in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert set(manifest["leaves"]) == ref_keys - {".rng", ".c", ".c_k"}
