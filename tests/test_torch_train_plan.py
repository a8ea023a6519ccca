"""Training under a sharding plan (launch/steps.py's train and AA steps of
a plan, models/layers.py's autograd Sharder, the fsdp regime over "data")
in gloo worlds of 2 and 4 processes on the CPU, against the JAX package,
at the reduced sizes.

Each world is ONE spawn of this file as a script (``spawn_world``, as
tests/test_torch_tensor_parallel.py). Every rank runs every case on a (1,
W) mesh and, in the world of 4, on a (2, 2) mesh: ``make_plan`` ->
``build_model(plan.cfg, sh=plan.sharder())`` loaded with
``convert.shard_lm_params`` of the reference's parameters, one
``make_train_step`` on the rank's shards with the rank's cut of a common
correction, and saves its loss, new parameters and r. The tests hold them
against the reference's ``make_train_step`` on the unsharded padded config,
cut by the port's spec, at slice T's gates: the loss within rel 1e-5, each
leaf's r (the gradient plus the correction) within 1e-4 of its norm, and
its new parameters within 1e-4 of the update's norm.

Families: smollm-135m (dense; and with 9 heads on 3 KV heads: the gather
GQA map), granite-moe-3b-a800m (``moe_sharded``), zamba2-7b with 3 layers
(hybrid), mamba2-2.7b, internvl2-76b (frontend embeds) and llama4-scout
in the fsdp regime (its weights split over "data" too on the (2, 2) mesh:
gathered per layer, their gradients reduce-scattered). The dense batches
carry a loss mask with unequal rows, so the (2, 2) loss is the global
token mean and not a mean of the data ranks' means; the MoE batches carry
none, and on the (2, 2) mesh their baseline is the mean of the reference's
steps on each row alone (capacity counts the rank's tokens, as the
reference's ``moe_sharded`` under a split batch).

The reference's own sharded step: one train step of smollm-135m under a
(2, 2) ``jax.sharding.Mesh`` of 4 host devices (a subprocess), against the
world of 4's (2, 2) run.

The AA step of a plan in f64, on the unsharded port's trajectory (four
train steps of smollm-135m in f64) cut to each rank: w⁺ within 1e-10 of the
unsharded port's step and within 1e-7 of the reference's ``make_aa_step``
with f64 helpers; θ within 1e-10. In this process: W = 1 (a gloo world of
one) is the unsharded port bit for bit, the train step and the AA step;
and ``aa_step_ref`` given ‖g‖² equal to its own sum is today's, bit for
bit.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, S, ETA = 2, 64, 0.1
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
WORLDS = (2, 4)
SPAWN_TIMEOUT = 300.0
#: case -> (arch, layers, config changes, regime)
CASES = {
    "smollm-135m": ("smollm-135m", None, {}, None),
    "smollm-135m-9-heads": ("smollm-135m", None, {"num_heads": 9, "num_kv_heads": 3}, None),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", None, {}, None),
    "zamba2-7b-3-layers": ("zamba2-7b", 3, {}, None),
    "mamba2-2.7b": ("mamba2-2.7b", None, {}, None),
    "internvl2-76b": ("internvl2-76b", None, {}, None),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", None, {}, "fsdp"),
}
#: (data, model) meshes of each world
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
#: the AA step's f64 cases: (case, mesh) in the world of 4 and of 2
AA_CASES = {2: [("smollm-135m", (1, 2))],
            4: [("smollm-135m", (2, 2)), ("llama4-scout-17b-a16e", (2, 2))]}
AA_HISTORY = 3


def reduced(get_arch, case, dtype=None):
    arch, layers, changes, _ = CASES[case]
    cfg = get_arch(arch).reduced()
    if layers:
        changes = {**changes, "num_layers": layers}
    if dtype:
        changes = {**changes, "dtype": dtype}
    return dataclasses.replace(cfg, **changes)


def batch_of(cfg, moe: bool) -> dict:
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if not moe:
        mask = np.ones((B, S), np.float32)
        mask[1, S // 2 + 5:] = 0.0           # unequal rows: a global token mean
        out["loss_mask"] = mask
    if cfg.frontend_tokens:
        out["embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the ranks' side: this file run as a script by spawn_world
# ---------------------------------------------------------------------------
def child(workdir: Path) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core.lm import unflatten
    from repro_torch.core.sharded import init_file_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_aa_step, make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    init_file_world(timeout_s=120.0)
    rank, W = dist.get_rank(), dist.get_world_size()
    refs = torch.load(workdir.parent / "inputs.pt", weights_only=False)
    out = {"steps": {}, "aa": {}}
    for D, M in MESHES[W]:
        mesh = make_mesh(D, M)
        for case in CASES:
            ref = refs["cases"][(case, M)]
            plan = make_plan(reduced(get_arch, case), mesh, regime=CASES[case][3])
            model = build_model(plan.cfg, device="cpu", sh=plan.sharder())
            model.load_state_dict(convert.shard_lm_params(ref["params"], plan, rank, "cpu"))
            params = {n: t.detach().clone() for n, t in model.named_parameters()}
            corr = convert.shard_lm_params(ref["correction"], plan, rank, "cpu")
            batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
            new, r, loss = make_train_step(model, eta=ETA)(params, batch, corr)
            out["steps"][(case, (D, M))] = dict(
                loss=float(loss), new={n: _np(t) for n, t in new.items()},
                r={n: _np(t) for n, t in r.items()},
                counts={k: dict(v) for k, v in model.sh.counts.items()})
        for case, mesh_dm in AA_CASES[W]:
            if mesh_dm != (D, M):
                continue
            aa = refs["aa"][case]
            plan = make_plan(reduced(get_arch, case, "float64"), mesh,
                             regime=CASES[case][3])
            model = build_model(plan.cfg, device="meta", sh=plan.sharder())
            layout, counted = convert.plan_flat_layout(
                dict(model.named_parameters()), plan, rank)
            full_layout = [(n, torch.Size(s)) for n, s in aa["layout"]]

            def cut(v):
                parts = convert.shard_lm_params(
                    convert.lm_unflat_params(torch.from_numpy(v), _Named(full_layout)),
                    plan, rank, "cpu")
                return torch.cat([parts[n].reshape(-1) for n, _ in layout])

            step = make_aa_step(eta=ETA, history=AA_HISTORY, plan=plan, counted=counted)
            w_new, theta = step(cut(aa["w"]), cut(aa["g"]),
                                torch.stack([cut(v) for v in aa["s"]]),
                                torch.stack([cut(v) for v in aa["y"]]))
            out["aa"][case] = dict(w=unflatten(w_new, layout), theta=float(theta),
                                   counted=counted, d=w_new.numel(),
                                   counts=dict(step.counts))
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


class _Named:
    """What convert.lm_unflat_params reads of a model: its parameters'
    names and shapes (core/lm.py::param_layout)."""

    def __init__(self, layout):
        self._layout = layout

    def named_parameters(self):
        return [(n, torch.empty(s, device="meta")) for n, s in self._layout]


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def port_params(cfg, seed: int, scale: float | None = None) -> dict:
    """Parameters of the padded config ``cfg`` drawn by the port (its
    padded heads' zero rows included) as the reference's nested numpy
    tree; with ``scale``, normal draws of that scale in each leaf's shape
    (a correction)."""
    from repro_torch.core import convert
    from repro_torch.core.lm import flatten_params
    from repro_torch.models.decoder import build_model

    model = build_model(cfg, device="cpu", seed=seed)
    w = flatten_params(model)
    if scale is not None:
        w = scale * torch.randn(w.shape, generator=torch.Generator().manual_seed(seed),
                                dtype=w.dtype)
    return convert.lm_unflat_params(w, model)


def case_inputs(cfg, moe: bool) -> dict:
    """A case's inputs on the padded config ``cfg``, drawn by the port:
    params, a correction (nested numpy, the reference's tree) and the
    batch."""
    return dict(params=port_params(cfg, 0), correction=port_params(cfg, 1, scale=1e-3),
                batch=batch_of(cfg, moe))


def reference_case(jcfg, inp: dict, rowwise: bool) -> dict:
    """The reference's train step on ``jcfg`` from ``inp`` (case_inputs)
    on the whole batch, or (``rowwise``: the MoE cases of a split batch)
    the mean of its steps on each row alone: new params, r (as numpy) and
    the loss."""
    import jax

    from repro.launch.steps import make_train_step as jax_train_step
    from repro.models.decoder import build_model as jax_build_model

    from jax_compile import compiled

    jm = jax_build_model(jcfg)
    params = jax.tree.map(jax.numpy.asarray, inp["params"])
    corr = jax.tree.map(jax.numpy.asarray, inp["correction"])
    batch = inp["batch"]
    parts = ([{k: v[i:i + 1] for k, v in batch.items()} for i in range(B)]
             if rowwise else [batch])
    parts = [{k: jax.numpy.asarray(v) for k, v in b.items()} for b in parts]
    step = compiled(jax_train_step(jm, eta=ETA), params, parts[0], corr)
    runs = [step(params, b, corr) for b in parts]
    as_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    r = jax.tree.map(lambda *a: sum(a) / len(a), *[as_np(x[1]) for x in runs])
    new = (as_np(runs[0][0]) if not rowwise else
           jax.tree.map(lambda w, ri: (w - ETA * ri).astype(w.dtype), inp["params"], r))
    return dict(new=new, r=r, loss=float(np.mean([float(x[2]) for x in runs])))


def port_aa(case) -> dict:
    """The unsharded port's f64 trajectory (four train steps) as flat
    vectors in its layout, and the unsharded port's AA step on them."""
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core.lm import param_layout
    from repro_torch.launch.steps import make_aa_step, make_train_step
    from repro_torch.models.decoder import build_model

    cfg = reduced(get_arch, case, "float64").padded(2)
    model = build_model(cfg, device="cpu", seed=0)
    layout = param_layout(model)
    params = {n: t.detach().clone() for n, t in model.named_parameters()}
    corr = {n: torch.zeros_like(t) for n, t in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, bool(cfg.num_experts)).items()}
    step = make_train_step(model, eta=0.05)

    def flat(d):
        return torch.cat([d[n].reshape(-1) for n, _ in layout])
    # w_0 .. w_m and r_i at w_i: S and Y of the m steps, the AA step at w_m
    ws, rs = [], []
    for _ in range(AA_HISTORY + 1):
        ws.append(flat(params))
        params, r, _ = step(params, batch, corr)
        rs.append(flat(r))
    s = torch.stack([ws[i + 1] - ws[i] for i in range(AA_HISTORY)])
    y = torch.stack([rs[i + 1] - rs[i] for i in range(AA_HISTORY)])
    w, g = ws[-1], rs[-1]
    port_w, port_theta = make_aa_step(eta=ETA, history=AA_HISTORY)(w, g, s, y)
    return dict(layout=[(n, tuple(sh)) for n, sh in layout],
                w=w.numpy(), g=g.numpy(), s=s.numpy(), y=y.numpy(),
                port_w=port_w.numpy(), port_theta=float(port_theta))


def reference_aa(aa: dict) -> dict:
    """The reference's ``make_aa_step`` on ``port_aa``'s vectors, with f64
    helpers."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_aa_step as jax_aa_step
    from repro.utils import tree_math as jax_tm

    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
        mp.setattr(jax_tm, "tree_vdot_stacked", lambda s_, v: s_ @ v)
        mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
        mp.setattr(jax_tm, "tree_combine_stacked", lambda s_, c: c @ s_)
        ref_w, ref_theta = jax.jit(jax_aa_step(eta=ETA, history=AA_HISTORY))(
            *(jnp.asarray(aa[k]) for k in ("w", "g", "s", "y")))
        ref_w, ref_theta = np.asarray(ref_w), np.asarray(ref_theta)
    jax.config.update("jax_enable_x64", was)
    return dict(ref_w=ref_w, ref_theta=float(ref_theta))


#: the reference's train step of smollm-135m under a (2, 2) mesh of 4 host
#: devices (a jax.sharding.Mesh: its axes are Auto, ROADMAP.md section 3),
#: from ref_tp_inputs.npz; writes ref_tp_outputs.npz
REFERENCE_TP_STEP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.steps import make_train_step
from repro.models.decoder import build_model
from repro.sharding.specs import batch_axis, make_plan, param_specs
d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "ref_tp_inputs.npz")))
def nest(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(v)
    return out
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
plan = make_plan(get_arch("smollm-135m").reduced(), mesh)
jm = build_model(plan.cfg, plan.sharder())
params, corr, batch = nest("params/"), nest("correction/"), nest("batch/")
p_shard = jax.tree.map(lambda s: NamedSharding(mesh, s), param_specs(params, plan),
                       is_leaf=lambda x: isinstance(x, P))
ba = batch_axis(plan, batch["tokens"].shape[0])
b_shard = jax.tree.map(lambda x: NamedSharding(mesh, P(ba, *([None] * (x.ndim - 1)))), batch)
step = jax.jit(make_train_step(jm, eta=float(sys.argv[2])),
               in_shardings=(p_shard, b_shard, p_shard), out_shardings=(p_shard, p_shard, None))
new, r, loss = step(params, batch, corr)
flat = {"loss": np.asarray(loss)}
for kp, v in jax.tree_util.tree_flatten_with_path(r)[0]:
    flat["r/" + "/".join(k.key for k in kp)] = np.asarray(v)
np.savez(os.path.join(d, "ref_tp_outputs.npz"), **flat)
"""


#: the reference's steps of the (1, 4) mesh's padded configs, beside this
#: process's: reads inputs.pt and the keys, writes ref_m4.pt
REFERENCE_M4 = r"""
import sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[2])
import test_torch_train_plan as T
from repro.configs import get_arch
base = Path(sys.argv[1])
port = torch.load(base / "inputs.pt", weights_only=False)
out = {case: T.reference_case(T.reduced(get_arch, case).padded(4), port["cases"][(case, 4)],
                              rowwise=False) for case in sys.argv[3:]}
torch.save(out, base / "ref_m4.pt")
"""


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")]))
    return env


def _spawn(base: Path, W: int, results: dict) -> None:
    from repro_torch.core.sharded import spawn_world

    workdir = base / f"w{W}"
    workdir.mkdir()
    results[W] = (workdir, spawn_world(
        [sys.executable, str(Path(__file__).resolve()), str(workdir)], W,
        str(workdir / "store"), timeout_s=SPAWN_TIMEOUT, env=_env(), cwd=str(ROOT)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The port-drawn inputs; the worlds and the reference's (2, 2) step
    start on them at once, and the reference's steps run here meanwhile."""
    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import get_arch

    base = tmp_path_factory.mktemp("train_plan")
    port = {"cases": {}, "aa": {}}
    cfgs = {}
    for case in CASES:
        for M in (2, 4):
            cfg, jcfg = reduced(get_arch, case).padded(M), reduced(jax_get_arch, case).padded(M)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            cfgs[case, M] = jcfg
            port["cases"][(case, M)] = case_inputs(cfg, bool(cfg.num_experts))
    for case in {c for cases in AA_CASES.values() for c, _ in cases}:
        port["aa"][case] = port_aa(case)
    torch.save(port, base / "inputs.pt")
    results = {}
    threads = [threading.Thread(target=_spawn, args=(base, W, results)) for W in WORLDS]
    for t in threads:
        t.start()
    inp = port["cases"][("smollm-135m", 2)]
    np.savez(base / "ref_tp_inputs.npz", **{
        f"{name}/{k}": v for name in ("params", "correction", "batch")
        for k, v in _leaves(inp[name])})
    tp = subprocess.Popen([sys.executable, "-c", REFERENCE_TP_STEP, str(base), str(ETA)],
                          env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    # the (1, 4) configs that the (1, 2) ones do not already give, in a
    # second process
    apart = [case for case in CASES if cfgs[case, 4] != cfgs[case, 2]]
    m4 = subprocess.Popen([sys.executable, "-c", REFERENCE_M4, str(base),
                           str(ROOT / "tests"), *apart], env=_env(), cwd=str(ROOT),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    refs = {"cases": {}, "rowwise": {}, "aa": {}}
    for case in CASES:
        jcfg = cfgs[case, 2]
        refs["cases"][(case, 2)] = reference_case(jcfg, port["cases"][(case, 2)],
                                                  rowwise=False)
        if case not in apart:
            refs["cases"][(case, 4)] = refs["cases"][(case, 2)]
        if jcfg.num_experts:
            # the (2, 2) mesh splits the batch: each row routed alone
            refs["rowwise"][case] = reference_case(jcfg, port["cases"][(case, 2)],
                                                   rowwise=True)
    for case, aa in port["aa"].items():
        refs["aa"][case] = {**aa, **reference_aa(aa)}
    out, _ = m4.communicate(timeout=SPAWN_TIMEOUT)
    assert m4.returncode == 0, out[-4000:]
    for case, ref in torch.load(base / "ref_m4.pt", weights_only=False).items():
        refs["cases"][(case, 4)] = ref
    return dict(base=base, port=port, refs=refs, tp=tp, threads=threads, results=results)


@pytest.fixture(scope="module")
def worlds(inputs):
    for t in inputs["threads"]:
        t.join()
    out = {}
    for W, (workdir, res) in inputs["results"].items():
        for r, x in enumerate(res):
            assert x.returncode == 0, f"W={W} rank {r}: {x.stdout[-4000:]}"
        out[W] = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                  for r in range(W)]
    return out


@pytest.fixture(scope="module")
def reference_tp(inputs, worlds):
    tp = inputs["tp"]
    out, _ = tp.communicate(timeout=SPAWN_TIMEOUT)
    assert tp.returncode == 0, out[-4000:]
    return dict(np.load(inputs["base"] / "ref_tp_outputs.npz"))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
def rank_cut(tree, case, D, M, rank, dtype=None) -> dict:
    """The reference's tree (nested numpy) of ``case``'s padded config as
    the port's state-dict names, cut for ``rank`` of a (D, M) mesh by the
    port's spec."""
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.sharding.specs import make_plan

    class ShapeMesh:
        shape = {"data": D, "model": M}

    plan = make_plan(reduced(get_arch, case, dtype), ShapeMesh, regime=CASES[case][3])
    return {n: t.numpy() for n, t in convert.shard_lm_params(tree, plan, rank,
                                                             "cpu").items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def all_runs():
    return [(W, case, dm) for W in WORLDS for dm in MESHES[W] for case in CASES]


@pytest.mark.parametrize("W,case,mesh", all_runs(),
                         ids=[f"W{W}-{c}-{d}x{m}" for W, c, (d, m) in all_runs()])
def test_train_step_of_a_plan_matches_reference(inputs, worlds, W, case, mesh):
    from repro_torch.configs import get_arch

    D, M = mesh
    moe = bool(get_arch(CASES[case][0]).num_experts)
    ref = (inputs["refs"]["rowwise"][case] if moe and D > 1
           else inputs["refs"]["cases"][(case, M)])
    start_params = inputs["port"]["cases"][(case, M)]["params"]
    for rank, got in enumerate(worlds[W]):
        g = got["steps"][(case, mesh)]
        assert abs(g["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]), \
            (case, mesh, rank, g["loss"], ref["loss"])
        want_r = rank_cut(ref["r"], case, D, M, rank)
        want_new = rank_cut(ref["new"], case, D, M, rank)
        start = rank_cut(start_params, case, D, M, rank)
        assert set(g["r"]) == set(want_r)
        for n in want_r:
            assert g["r"][n].shape == want_r[n].shape, n
            assert _rel(g["r"][n], want_r[n]) <= GRAD_TOL, (case, mesh, rank, n)
            upd = np.linalg.norm(want_new[n].astype(np.float64) - start[n])
            assert np.linalg.norm(g["new"][n].astype(np.float64) - want_new[n]) \
                <= GRAD_TOL * max(upd, 1e-30), (case, mesh, rank, n)


def test_fsdp_gathers_and_reduce_scatters_over_data(worlds):
    """llama4-scout's (2, 2) fsdp step all-gathers its data-split weights
    and reduce-scatters their gradients over "data", in equal bytes: a
    rank puts in its shard and gets the whole weight forward, puts in the
    whole gradient and gets its shard back."""
    for rank, got in enumerate(worlds[4]):
        c = got["steps"][("llama4-scout-17b-a16e", (2, 2))]["counts"]
        ag = c["all_gather"]["by_axis"]["data"]
        rs = c["reduce_scatter"]["by_axis"]["data"]
        assert ag["calls"] == rs["calls"] > 0
        assert rs["bytes"] == 2 * ag["bytes"]


def test_reference_sharded_step(inputs, worlds, reference_tp):
    """The reference's own train step under a (2, 2) mesh of 4 host
    devices against the port's (2, 2) world: the loss and r."""
    ref_r = {}
    for k, v in reference_tp.items():
        if k.startswith("r/"):
            node = ref_r
            *parents, leaf = k[2:].split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = v
    for rank, got in enumerate(worlds[4]):
        g = got["steps"][("smollm-135m", (2, 2))]
        want = float(reference_tp["loss"])
        assert abs(g["loss"] - want) <= LOSS_TOL * abs(want)
        cut = rank_cut(ref_r, "smollm-135m", 2, 2, rank)
        for n, v in cut.items():
            assert _rel(g["r"][n], v) <= GRAD_TOL, (rank, n)


@pytest.mark.parametrize("W,case", [(W, c) for W, cs in AA_CASES.items() for c, _ in cs])
def test_aa_step_of_a_plan_in_f64(inputs, worlds, W, case):
    from repro_torch.core import convert

    aa = inputs["refs"]["aa"][case]
    D, M = dict(AA_CASES[W])[case]
    layout = [(n, torch.Size(s)) for n, s in aa["layout"]]
    want = {name: convert.lm_unflat_params(torch.from_numpy(aa[name]), _Named(layout))
            for name in ("port_w", "ref_w")}
    ref_scale = np.linalg.norm(aa["ref_w"])
    counted = 0
    for rank, got in enumerate(worlds[W]):
        g = got["aa"][case]
        counted += g["counted"]
        assert g["counts"] == {"all_reduce": {"calls": 1, "bytes": 8 * (3 * 3 + 3 + 1)}}
        assert abs(g["theta"] - aa["port_theta"]) <= 1e-10
        port = rank_cut(want["port_w"], case, D, M, rank, "float64")
        ref = rank_cut(want["ref_w"], case, D, M, rank, "float64")
        for n, t in g["w"].items():
            t = t.numpy()
            assert np.abs(t - port[n]).max() <= 1e-10 * np.abs(aa["port_w"]).max(), n
            assert np.linalg.norm(t - ref[n]) <= 1e-7 * ref_scale, n
    # every element counted on exactly one rank of the world
    assert counted == aa["w"].size


# ---------------------------------------------------------------------------
# in this process: a world of one, and the plain AA step's given norm
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["smollm-135m", "granite-moe-3b-a800m",
                                  "zamba2-7b-3-layers", "llama4-scout-17b-a16e"])
def test_world_of_one_is_the_unsharded_port_bit_for_bit(host_mesh, case):
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core.lm import param_layout
    from repro_torch.launch.steps import make_aa_step, make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    cfg = reduced(get_arch, case)
    plan = make_plan(cfg, host_mesh, regime=CASES[case][3])
    assert plan.cfg == cfg
    plain = build_model(cfg, device="cpu", seed=0)
    model = build_model(plan.cfg, device="cpu", seed=0, sh=plan.sharder())
    batch = {k: torch.from_numpy(v) for k, v in
             batch_of(cfg, bool(cfg.num_experts)).items()}
    params = {n: t.detach().clone() for n, t in plain.named_parameters()}
    corr = {n: torch.full_like(t, 1e-3) for n, t in params.items()}
    flat_of = lambda d, lay: torch.cat([d[n].reshape(-1) for n, _ in lay])  # noqa: E731
    layout, counted = convert.plan_flat_layout(dict(model.named_parameters()), plan, 0)
    assert layout == param_layout(plain) and counted == sum(s.numel() for _, s in layout)
    runs = []
    for m, aa in ((plain, make_aa_step(eta=ETA)),
                  (model, make_aa_step(eta=ETA, plan=plan, counted=counted))):
        p, ws, rs = dict(params), [], []
        for _ in range(AA_HISTORY + 1):
            p, r, loss = make_train_step(m, eta=ETA)(p, batch, corr)
            ws.append(flat_of(p, layout))
            rs.append(flat_of(r, layout))
        s = torch.stack([ws[i + 1] - ws[i] for i in range(AA_HISTORY)])
        y = torch.stack([rs[i + 1] - rs[i] for i in range(AA_HISTORY)])
        runs.append((loss, ws, rs, aa(ws[-1], rs[-1], s, y)))
    (la, wa, ra, (xa, ta)), (lb, wb, rb, (xb, tb)) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(wa + ra, wb + rb))
    assert torch.equal(xa, xb) and torch.equal(ta, tb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_aa_step_ref_given_its_own_norm_is_bit_for_bit(dtype):
    """``aa_step_ref`` given ‖g‖² equal to the sum it makes itself returns
    today's w⁺, Γ and stats bit for bit (the kernel's twin: its given norm
    replaces its own sum, csrc/update.cu)."""
    from repro_torch.kernels.anderson import aa_step_ref, gram_ref

    g = torch.Generator().manual_seed(5)
    K, m, d = 3, 4, 300
    s, y = (torch.randn(K, m, d, generator=g, dtype=dtype) for _ in range(2))
    w, gv = (torch.randn(K, d, generator=g, dtype=dtype) for _ in range(2))
    gram, yg = gram_ref(y, gv)
    kw = dict(damping=1.0, tikhonov=1e-8, filter_rtol=0.0, clip_rtol=0.0)
    plain = aa_step_ref(w, gv, s, y, gram, yg, 0.1, **kw)
    given = aa_step_ref(w, gv, s, y, gram, yg, 0.1, **kw, g_norm2=(gv * gv).sum(-1))
    for a, b in zip(plain, given):
        assert torch.equal(a, b)
    meta = aa_step_ref(w, gv, s, y, gram, yg, 0.1, **kw, stop_early=False)
    for a, b in zip(plain, meta):
        assert torch.equal(a, b)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    child(Path(sys.argv[1]))
    sys.exit(0)
