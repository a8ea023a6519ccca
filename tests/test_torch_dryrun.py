"""launch/dryrun.py against the reference, on the CPU.

``dryrun_one``: rank 0 of a fake world of 256 (or 512) ranks runs a pair's
step on meta tensors (one subprocess per mesh, a fake world each). Four
pairs: granite-moe-3b-a800m train_4k on 16 x 16 (expert parallel, the
committed reference row's 1,040,324,608 argument bytes), llama4-scout
train_4k on 2 x 16 x 16 (the fsdp regime over ("pod", "data")),
smollm-135m decode_32k and zamba2-7b long_500k (caches; the sliding
window). Each record's structural fields and argument bytes are held
against the reference's, computed from its specs without compiling:
``jax.eval_shape`` of the padded model (and its caches) cut by
``param_specs`` / ``cache_specs``, the batch cut by ``batch_axis``.

``--fl-round``: core/sharded.py's round in gloo worlds of 2 and 4 (ONE
spawn of this file as a script each, as tests/test_torch_sharded_ranks.py),
for fedosaa_svrg on the identity wire (through the CLI) and giant on the
int8 wire (fed the reference's uniforms), 2 rounds each, against the
reference's ``dryrun_fl_round`` rerun in a subprocess on 512 emulated host
devices: loss curve within rel 1e-6, rel-error curve within 1e-5,
``comm_bytes`` equal. Both sides in f64, the reference with f64 helpers
(ROADMAP.md, "judge parity in f64"): in f32 the AA step of this workload
(Gram condition numbers 1e7–2e9) is roundoff-bound, so the reference's
own vmap and sharded rounds part by 1.6% in the second loss (ROADMAP §3).
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PAIRS = {"16x16": [("granite-moe-3b-a800m", "train_4k"), ("smollm-135m", "decode_32k"),
                   ("zamba2-7b", "long_500k")],
         "2x16x16": [("llama4-scout-17b-a16e", "train_4k")]}
#: memory.argument_bytes of the committed reference row
#: benchmarks/results/dryrun/granite-moe-3b-a800m__train_4k__16x16.json
GRANITE_TRAIN_BYTES = 1_040_324_608
FL_ROUNDS, FL_WORLDS = 2, (2, 4)
#: case -> (algo, wire)
FL_CASES = {"fedosaa_svrg": ("fedosaa_svrg", "identity"), "giant-int8": ("giant", "int8")}
SPAWN_TIMEOUT = 300.0

PORT_DRYRUN = r"""
import json, sys
from repro_torch.launch.dryrun import dryrun_one
out, multi_pod = sys.argv[1], sys.argv[2] == "2x16x16"
for pair in sys.argv[3:]:
    arch, shape = pair.split(":")
    json.dump(dryrun_one(arch, shape, multi_pod), open(f"{out}/{arch}__{shape}.json", "w"))
"""

REFERENCE_FL = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))
import json
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.utils import tree_math as jtm
# f64 helpers: the reference's tree_math accumulates in f32
jtm.tree_vdot_stacked = lambda s, v: s @ v
jtm.tree_dot = lambda a, b: jnp.sum(a * b)
jtm.tree_gram = lambda a, b: a @ b.T
jtm.tree_combine_stacked = lambda s, c: c @ s
import repro.models.logreg as lr
_problem = lr.make_logreg_problem
lr.make_logreg_problem = lambda clients, gamma=1e-3: _problem(clients, gamma,
                                                              dtype=jnp.float64)
from repro.comm import make_channel
from repro.core.algorithms import UPLINK_SCHEMAS
from repro.core import AlgoHParams, init_state
from repro.data import make_binary_classification, partition
from repro.launch.dryrun import dryrun_fl_round

out, rounds = sys.argv[1], int(sys.argv[2])
# first giant's int8 uniforms (the port's ranks wait for them), round by
# round: the round's client keys
# split(split(rng, 3)[2], K), each folded with the uplink's fold, then 0;
# the next round's key split(rng, 3)[0]
K = 64
X, y = make_binary_classification("synthetic_small", n=8192, seed=0)
prob = lr.make_logreg_problem(partition(X, y, num_clients=K, scheme="iid"))
st = init_state(prob, jax.random.PRNGKey(0), AlgoHParams(eta=1.0, local_epochs=10),
                make_channel("int8"), "giant")
nc = -(-int(prob.clients.x.shape[-1]) // 256)
rng, draws = st.rng, {}
for t in range(rounds):
    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    for s in UPLINK_SCHEMAS["giant"]:
        draws[f"{t}/{s.tag}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, s.fold), 0), (nc, 256),
            jnp.float32)) for k in keys])
    rng = jax.random.split(rng, 3)[0]
np.savez(os.path.join(out, "draws_tmp.npz"), **draws)
os.replace(os.path.join(out, "draws_tmp.npz"), os.path.join(out, "reference_draws.npz"))
res = {"fedosaa_svrg": dryrun_fl_round("fedosaa_svrg", rounds=rounds),
       "giant-int8": dryrun_fl_round("giant", comm_codec="int8", rounds=rounds)}
json.dump(res, open(os.path.join(out, "reference_fl.json"), "w"))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")]))
    return env


def _spawn(base: Path, W: int, results: dict) -> None:
    from repro_torch.core.sharded import spawn_world

    workdir = base / f"fl{W}"
    workdir.mkdir()
    results[W] = (workdir, spawn_world(
        [sys.executable, str(Path(__file__).resolve()), str(workdir)], W,
        str(workdir / "store"), timeout_s=SPAWN_TIMEOUT, env=_env(), cwd=str(ROOT)))


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The port's dry-runs (one process a mesh), the reference's FL rerun
    and the port's FL worlds, started together."""
    base = tmp_path_factory.mktemp("dryrun")
    started = {}
    for mesh, pairs in PAIRS.items():
        (base / mesh).mkdir()
        started[mesh] = subprocess.Popen(
            [sys.executable, "-c", PORT_DRYRUN, str(base / mesh), mesh]
            + [f"{a}:{s}" for a, s in pairs], env=_env(), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    started["reference"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_FL, str(base), str(FL_ROUNDS)], env=_env(),
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    results = {}
    threads = [threading.Thread(target=_spawn, args=(base, W, results))
               for W in FL_WORLDS]
    for t in threads:
        t.start()
    yield base, {**started, "worlds": (threads, results)}
    for p in started.values():
        if p.poll() is None:
            p.kill()
    for t in threads:
        t.join()


def _wait(p, what):
    out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
    assert p.returncode == 0, f"{what}:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def port_records(procs):
    base, started = procs
    out = {}
    for mesh, pairs in PAIRS.items():
        _wait(started[mesh], f"the port's dry-run on {mesh}")
        for arch, shape in pairs:
            out[(arch, shape)] = json.load(open(base / mesh / f"{arch}__{shape}.json"))
    return out


# ---------------------------------------------------------------------------
# the reference's specs, without compiling
# ---------------------------------------------------------------------------
def _cut_bytes(shape, dtype, spec, mesh_shape) -> int:
    n = 1
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= size // int(np.prod([mesh_shape.get(a, 1) for a in axes]))
    return n * np.dtype(dtype).itemsize


def _tree_bytes(tree, spec_tree, mesh_shape) -> int:
    import jax
    from jax.sharding import PartitionSpec
    leaves = jax.tree.leaves(tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(specs)
    return sum(_cut_bytes(x.shape, x.dtype, tuple(s), mesh_shape)
               for x, s in zip(leaves, specs))


def reference_record(arch: str, shape_name: str, mesh: str) -> dict:
    import jax

    from repro.configs import get_arch, get_shape
    from repro.launch import specs_io
    from repro.models.decoder import build_model
    from repro.sharding import specs

    multi_pod = mesh == "2x16x16"
    mesh_shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                  else {"data": 16, "model": 16})

    class ShapeMesh:
        shape = mesh_shape

    shape = get_shape(shape_name)
    plan = specs.make_plan(specs_io.effective_cfg(get_arch(arch), shape), ShapeMesh,
                           multi_pod)
    cfg = plan.cfg
    jm = build_model(cfg)
    p = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = _tree_bytes(p, specs.param_specs(p, plan), mesh_shape)
    B = shape.global_batch
    ba = specs.batch_axis(plan, B)
    rows = int(np.prod([mesh_shape[a] for a in ((ba,) if isinstance(ba, str)
                                                  else ba or ())]))
    io = specs_io.batch_specs_for(cfg, shape)
    io_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize // rows
                   for x in jax.tree.leaves(io))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "chips": 512 if multi_pod else 256, "regime": plan.regime,
           "attn_variant": "sliding_window" if cfg.sliding_window else
                           ("none" if not cfg.num_heads else "full_causal"),
           "batch_axis": str(ba), "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if shape.kind == "train":
        rec["argument_bytes"] = 2 * params + io_bytes
    else:
        C = specs_io.cache_len_for(cfg, shape)
        caches = specs_io.caches_shape(jm, B, C)
        rec["cache_len"] = C
        rec["argument_bytes"] = (params + io_bytes + _tree_bytes(
            caches, specs.cache_specs(caches, plan, B), mesh_shape))
    return rec


@pytest.mark.parametrize("arch,shape,mesh", [(a, s, m) for m, ps in PAIRS.items()
                                             for a, s in ps])
def test_dryrun_one_matches_the_reference_specs(port_records, arch, shape, mesh):
    got = port_records[(arch, shape)]
    want = reference_record(arch, shape, mesh)
    for k, v in want.items():
        have = got["memory"][k] if k == "argument_bytes" else got[k]
        assert have == v, (k, have, v)
    assert got["flops"] > 0
    assert got["bytes_accessed"] is None and got["memory"]["temp_bytes"] is None
    assert got["collectives"]["all-reduce_count"] > 0
    if shape == "train_4k":
        aa = got["aa_step"]
        assert aa["flops"] > 0
        assert aa["collectives"] == {"all-reduce": 8 * (3 * 3 + 3 + 1),
                                     "all-reduce_count": 1}
    if got["regime"] == "fsdp":
        by_axis = got["collectives"]["by_axis"]
        assert by_axis["all-gather"]["pod,data"]["calls"] > 0
        assert by_axis["reduce-scatter"]["pod,data"]["calls"] > 0


def test_granite_train_argument_bytes_is_the_committed_row(port_records):
    committed = json.load(open(ROOT / "benchmarks/results/dryrun/"
                               "granite-moe-3b-a800m__train_4k__16x16.json"))
    assert committed["memory"]["argument_bytes"] == GRANITE_TRAIN_BYTES
    got = port_records[("granite-moe-3b-a800m", "train_4k")]
    assert got["memory"]["argument_bytes"] == GRANITE_TRAIN_BYTES


# ---------------------------------------------------------------------------
# --fl-round in gloo worlds
# ---------------------------------------------------------------------------
def child(workdir: Path) -> None:
    import torch.distributed as dist

    from repro_torch.core.sharded import init_file_world
    from repro_torch.launch import dryrun

    init_file_world(timeout_s=120.0)
    rank = dist.get_rank()
    out = {}
    # through the CLI: rank 0 writes the record
    assert dryrun.main(["--fl-round", "fedosaa_svrg", "--fl-rounds", str(FL_ROUNDS),
                        "--fl-dtype", "float64", "--device", "cpu",
                        "--out-dir", str(workdir)]) == 0
    path = workdir.parent / "reference_draws.npz"
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.2)
    draws = dict(np.load(path))
    out["giant-int8"] = dryrun.dryrun_fl_round(
        "giant", comm_codec="int8", rounds=FL_ROUNDS, device="cpu", dtype="float64",
        draws=lambda t: {k.split("/")[1]: torch.from_numpy(v)
                         for k, v in draws.items() if k.startswith(f"{t}/")})
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def fl_runs(procs):
    base, started = procs
    _wait(started["reference"], "the reference's FL dry-run")
    ref = json.load(open(base / "reference_fl.json"))
    threads, results = started["worlds"]
    for t in threads:
        t.join()
    worlds = {}
    for W, (workdir, res) in results.items():
        for r, x in enumerate(res):
            assert x.returncode == 0, f"W={W} rank {r}: {x.stdout[-4000:]}"
        ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                 for r in range(W)]
        svrg = json.load(open(workdir / "fl_round__fedosaa_svrg__float64__16x16.json"))
        worlds[W] = [{"fedosaa_svrg": svrg, **got} for got in ranks]
    return ref, worlds


@pytest.mark.parametrize("case", list(FL_CASES))
@pytest.mark.parametrize("W", FL_WORLDS)
def test_fl_round_matches_the_reference_rerun(fl_runs, W, case):
    ref, worlds = fl_runs
    want = ref[case]
    for r, got in enumerate(worlds[W]):
        g = got[case]
        assert g["client_shards"] == W and g["mesh"] == want["mesh"] == "16x16"
        assert g["dtype"] == "float64" and g["channel"] == want["channel"]
        np.testing.assert_allclose(g["loss_curve"], want["loss_curve"], rtol=1e-6,
                                   err_msg=f"{case} W={W} rank {r}")
        np.testing.assert_allclose(g["rel_error_curve"], want["rel_error_curve"],
                                   rtol=1e-5, err_msg=f"{case} W={W} rank {r}")
        assert g["comm_bytes"] == want["comm_bytes"]


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    child(Path(sys.argv[1]))
    sys.exit(0)
