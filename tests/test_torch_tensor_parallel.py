"""Tensor-parallel serving (sharding/specs.py, launch/mesh.py, the Sharder,
``moe_sharded``) in gloo worlds of 2 and 4 processes on the CPU, against
the JAX package's unsharded model of the padded config, in f32 at the
reduced sizes.

Each world is ONE spawn of this file as a script (``spawn_world``, a
FileStore under the test's temporary directory, a 60 s collective timeout
and a subprocess timeout, as tests/test_torch_sharded_ranks.py). Every rank
of a world runs every case on a (1, W) mesh: ``make_plan(cfg, mesh)``,
``build_model(plan.cfg, sh=plan.sharder())`` loaded with
``convert.shard_lm_params`` of the reference's parameters of ``plan.cfg``,
and saves what it saw; the tests read it:

  * forward logits (whole [B, S, V], on every rank) within 1e-5 of the
    reference's largest |logit|, aux within 1e-6;
  * prefill: the last logits within 1e-5, and each rank's cache shard
    within 1e-5 of the reference's caches cut by the reference's
    ``cache_spec_for_path``;
  * 4 decode steps from the reference's prefill caches (each rank its
    shard, ``convert.shard_lm_caches``) at tests/test_torch_kv_quant.py's
    tolerance (1e-4), and the caches after them;
  * musicgen-medium with ``kv_quant``: 4 decode steps from empty int8
    caches, logits at 1e-4 while the rank's int8 codes all equal the
    reference's, 1e-2 once one differs (by one step), as
    test_torch_kv_quant.py;
  * the ranks' logits bit-equal;
  * ``moe_sharded`` (the rank's experts) against the reference's
    ``moe_sharded`` on ``make_host_mesh()``, with capacity and dropless,
    within 1e-5, aux within 1e-6;
  * in the world of 4, a (2, 2) mesh: each data rank computes its batch
    row, the logits gathered over "data"; smollm-135m and granite-moe-3b
    against the reference run on each row alone (MoE capacity counts the
    rank's tokens, as the reference's moe_sharded under a split batch; its
    aux is the mean over the data ranks), forward, prefill and decode;
    the fsdp regime (llama4-scout) over that data axis serves each row as
    the unsharded port model;
  * the reference's own tensor parallelism: ``moe_sharded`` and a dense
    block on a (1, 4) mesh of 4 host devices (a subprocess with
    ``--xla_force_host_platform_device_count=4``), against the world of 4.

Configs: smollm-135m (dense; and with 9 heads on 3 KV heads, whose padded
gather map sends some ranks' query heads to KV heads they do not hold: those
ranks all-gather K and V), granite-20b (MQA: KV replicated),
granite-moe-3b-a800m and llama4-scout-17b-a16e (``moe_sharded``),
zamba2-7b with 3 layers (hybrid: ``ssm_inner`` split, the gated norm's
sum, the shared block, a trailing Mamba-2 layer), internvl2-76b (frontend
embeds), musicgen-medium. In this process, on a gloo world of one: W = 1
is the unsharded port model bit for bit, in serving and in training.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, S, N_DECODE, PAD = 2, 128, 4, 8
TOL = 1e-5
#: the hybrid's logits and caches against the reference: the unsharded
#: port's own gate there (tests/test_torch_lm.py), whose SSD recurrence,
#: taken in order where the reference scans associatively, is ~1e-5 from
#: the reference's after the Mamba-2 layers; its tensor-parallel model is
#: held at TOL against the unsharded port model
REF_TOL = {"zamba2-7b-3-layers": 1e-4}
DECODE_TOL, CODE_MISMATCH_TOL = 1e-4, 1e-2
WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0
#: case -> (arch, layers, config changes)
CASES = {
    "smollm-135m": ("smollm-135m", None, {}),
    "smollm-135m-9-heads": ("smollm-135m", None, {"num_heads": 9, "num_kv_heads": 3}),
    "granite-20b": ("granite-20b", None, {}),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", None, {}),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", None, {}),
    "zamba2-7b-3-layers": ("zamba2-7b", 3, {}),
    "internvl2-76b": ("internvl2-76b", None, {}),
    "musicgen-medium": ("musicgen-medium", None, {}),
}
#: the kv_quant decode case and the (2, 2) mesh's cases
QUANT_CASE = "musicgen-medium"
DATA_CASES = ("smollm-135m", "granite-moe-3b-a800m")
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")


def reduced(get_arch, case):
    arch, layers, changes = CASES[case]
    cfg = get_arch(arch).reduced()
    if layers:
        changes = {**changes, "num_layers": layers}
    return dataclasses.replace(cfg, **changes)


def tokens_of(cfg, batch=B, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)


def embeds_of(cfg, batch=B):
    if not cfg.frontend_tokens:
        return None
    return np.random.default_rng(1).standard_normal(
        (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


class ShapeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


# ---------------------------------------------------------------------------
# the ranks' side: this file run as a script by spawn_world
# ---------------------------------------------------------------------------
def _np(t):
    return t.detach().cpu().numpy()


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


@torch.inference_mode()
def serve_case(model, plan, ref, rank, unsharded=False):
    """What a rank sees of one case: forward, prefill, decode from the
    reference's prefill caches (the rank's shard; all of them for the
    ``unsharded`` model)."""
    from repro_torch.core import convert

    tok, emb = torch.from_numpy(ref["tokens"]), ref["embeds"]
    emb = None if emb is None else torch.from_numpy(emb)
    logits, aux = model(tok, emb)
    last, caches = model.prefill(tok, emb, cache_len=S + PAD)
    out = {"forward": (_np(logits), float(aux)),
           "prefill": (_np(last), _tree_np(caches.tree)),
           "rows": caches.rows}
    caches = (convert.lm_caches(ref["prefill_caches"], plan.cfg, "cpu") if unsharded
              else convert.shard_lm_caches(ref["prefill_caches"], plan, rank,
                                           tok.shape[0], "cpu"))
    steps = []
    for t, pos, _ in ref["decode"]:
        logits, caches = model.decode_step(caches, torch.from_numpy(t),
                                           torch.from_numpy(pos))
        steps.append(_np(logits))
    out["decode"] = steps
    out["decode_caches"] = _tree_np(caches.tree)
    return out


#: the slot server's cases: its greedy tokens on the tensor-parallel model
#: equal the unsharded port model's (f32)
SERVER_CASES = ("smollm-135m", "granite-moe-3b-a800m", "zamba2-7b-3-layers")


def server_tokens(model, cfg) -> list:
    """The slot server's tokens for 5 requests on 2 slots (admissions reset
    slots mid-run)."""
    from repro_torch.launch.serve import Request, SlotServer

    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 6).astype(np.int32), 4)
            for i in range(5)]
    SlotServer(model, 2, 12, device="cpu").run(reqs)
    return [r.out for r in reqs]


@torch.inference_mode()
def quant_decode(model, ref):
    caches = model.init_caches(B, S + PAD, "cpu")
    steps, codes = [], []
    for t, pos, _ in ref["quant_decode"]:
        logits, caches = model.decode_step(caches, torch.from_numpy(t),
                                           torch.from_numpy(pos))
        steps.append(_np(logits))
        codes.append({n: _np(caches.tree[n]).copy() for n in ("k", "v")})
    return steps, codes


def child(workdir: Path) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core.sharded import init_file_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as Lyr
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan, rank_coords, shard_slices

    init_file_world(timeout_s=60.0)
    rank, W = dist.get_rank(), dist.get_world_size()
    refs = torch.load(workdir.parent / "inputs.pt", weights_only=False)
    mesh = make_mesh(1, W)

    def sharded(case, mesh, ref):
        plan = make_plan(reduced(get_arch, case), mesh)
        model = build_model(plan.cfg, device="cpu", sh=plan.sharder())
        model.load_state_dict(convert.shard_lm_params(ref["params"], plan, rank, "cpu"))
        return plan, model

    out = {"cases": {}, "moe": {}, "counts": {}}
    for case in CASES:
        ref = refs["cases"][(case, W)]
        plan, model = sharded(case, mesh, ref)
        out["cases"][case] = serve_case(model, plan, ref, rank)
        out["counts"][case] = {k: dict(v) for k, v in model.sh.counts.items()}
        # the unsharded port model of the same parameters
        plain = build_model(plan.cfg, device="cpu")
        plain.load_state_dict(convert.lm_params(ref["params"], plan.cfg, "cpu"))
        out["cases"][case]["unsharded"] = serve_case(plain, plan, ref, 0,
                                                     unsharded=True)
        if case in SERVER_CASES:
            out["cases"][case]["server"] = (server_tokens(model, plan.cfg),
                                            server_tokens(plain, plan.cfg))
        if case == QUANT_CASE:
            qplan = make_plan(dataclasses.replace(reduced(get_arch, case),
                                                  kv_quant=True), mesh)
            qmodel = build_model(qplan.cfg, device="cpu", sh=qplan.sharder())
            qmodel.load_state_dict(model.state_dict())
            out["quant"] = quant_decode(qmodel, ref)
        if W == 4 and case == "smollm-135m":
            # the dense block of the reference's (1, 4)-mesh run
            tp = refs["tp_inputs"]
            with torch.inference_mode():
                h = torch.from_numpy(tp["dense_h"])
                pos = torch.arange(S, dtype=torch.int32).expand(B, S)
                out["dense_block"] = _np(model.blocks[0](h, plan.cfg, pos, 0)[0])
    # the layer: moe_sharded on the rank's experts, capacity and dropless
    for arch in MOE_ARCHS:
        m = refs["moe"][arch]
        plan = make_plan(get_arch(arch).reduced(), mesh)
        coords = rank_coords(plan, rank)
        p = {}
        for name, a in m["params"].items():
            spec = {"router": (None, None)}.get(name, ("model", None, None))
            p[name] = torch.from_numpy(a)[shard_slices(spec, a.shape, plan.mesh.shape,
                                                       coords)].contiguous()
        with torch.inference_mode():
            for dropless in (False, True):
                y, aux = Lyr.moe_sharded(Lyr.Params(p), torch.from_numpy(m["x"]),
                                         plan.cfg, plan.sharder(), dropless=dropless)
                out["moe"][(arch, dropless)] = (_np(y), float(aux))
    if W == 4:
        # a (2, 2) mesh: each data rank its batch row
        mesh22 = make_mesh(2, 2)
        out["data"] = {}
        for case in DATA_CASES:
            ref = refs["data"][case]
            plan, model = sharded(case, mesh22, ref)
            out["data"][case] = serve_case(model, plan, ref, rank)
            plain = build_model(plan.cfg, device="cpu")
            plain.load_state_dict(convert.lm_params(ref["params"], plan.cfg, "cpu"))
            # 2 slots over 2 data ranks: a rank's caches hold one slot
            out["data"][case]["server"] = (server_tokens(model, plan.cfg),
                                           server_tokens(plain, plan.cfg))
        # the fsdp regime over the data axis: each weight's data half held,
        # gathered per layer; against the unsharded port model on each row
        ref = refs["cases"][("llama4-scout-17b-a16e", 2)]
        plan = make_plan(reduced(get_arch, "llama4-scout-17b-a16e"), mesh22,
                         regime="fsdp")
        model = build_model(plan.cfg, device="cpu", sh=plan.sharder())
        model.load_state_dict(convert.shard_lm_params(ref["params"], plan, rank, "cpu"))
        plain = build_model(plan.cfg, device="cpu")
        plain.load_state_dict(convert.lm_params(ref["params"], plan.cfg, "cpu"))
        tok = torch.from_numpy(ref["tokens"])
        with torch.inference_mode():
            logits, aux = model(tok)
            rows = [plain(tok[i:i + 1]) for i in range(B)]
        out["fsdp"] = dict(
            logits=_np(logits), aux=float(aux),
            want=np.concatenate([_np(l) for l, _ in rows]),
            want_aux=float(np.mean([float(a) for _, a in rows])),
            shapes={n: tuple(t.shape) for n, t in model.state_dict().items()},
            full={n: tuple(t.shape) for n, t in plain.state_dict().items()},
            counts={k: dict(v) for k, v in model.sh.counts.items()})
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
def reference_case(jcfg, batch_rows=slice(0, B), quant=False):
    """The reference's results on one padded config: its parameters,
    forward, prefill (last logits, caches) and decode steps from those
    caches, on the batch rows ``batch_rows`` of the case's inputs; with
    ``quant``, also the kv_quant config's decode of the first tokens from
    empty int8 caches (logits and codes each step)."""
    import jax
    import jax.numpy as jnp

    from repro.models.decoder import build_model as jax_build_model

    from jax_compile import compiled

    jm = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = compiled(jm.init, key)(key)
    tokens = tokens_of(jcfg)[batch_rows]
    embeds = embeds_of(jcfg)
    embeds = None if embeds is None else embeds[batch_rows]
    t = jnp.asarray(tokens)
    e = None if embeds is None else jnp.asarray(embeds)
    ref = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "embeds": embeds}
    logits, aux = compiled(lambda p, t_, e_: jm.forward(p, t_, e_), params, t, e)(params, t, e)
    ref["forward"] = (np.asarray(logits), float(aux))
    last, caches = compiled(lambda p, t_, e_: jm.prefill(p, t_, e_, cache_len=S + PAD),
                            params, t, e)(params, t, e)
    ref["prefill"] = np.asarray(last)
    ref["prefill_caches"] = jax.tree.map(np.asarray, caches)
    n = tokens.shape[0]
    dec = compiled(jm.decode_step, params, caches, jnp.zeros((n, 1), jnp.int32),
                   jnp.zeros((n, 1), jnp.int32))
    steps, tok = [], np.argmax(ref["prefill"], -1)[:, None].astype(np.int32)
    for i in range(N_DECODE):
        pos = np.full((n, 1), S + i, np.int32)
        lg, caches = dec(params, caches, jnp.asarray(tok), jnp.asarray(pos))
        steps.append((tok, pos, np.asarray(lg)))
        tok = np.argmax(np.asarray(lg), -1)[:, None].astype(np.int32)
    ref["decode"] = steps
    ref["decode_caches"] = jax.tree.map(np.asarray, caches)
    if quant:
        qm = jax_build_model(dataclasses.replace(jcfg, kv_quant=True))
        qc = jax.jit(lambda: qm.init_caches(n, S + PAD))()
        qdec = compiled(qm.decode_step, params, qc, jnp.zeros((n, 1), jnp.int32),
                        jnp.zeros((n, 1), jnp.int32))
        qsteps, qcodes = [], []
        for i in range(N_DECODE):
            tk, pos = tokens[:, i:i + 1], np.full((n, 1), i, np.int32)
            lg, qc = qdec(params, qc, jnp.asarray(tk), jnp.asarray(pos))
            qsteps.append((tk, pos, np.asarray(lg)))
            qcodes.append({k: np.asarray(qc[k]) for k in ("k", "v")})
        ref["quant_decode"], ref["quant_codes"] = qsteps, qcodes
    return ref


def reference_moe(jax_get_arch, arch):
    """The reference's layer on the reduced config padded for 4 ranks
    (its experts: 4, unpadded at 2 and 4 ranks): params, an input, and its
    ``moe_sharded`` on ``make_host_mesh()`` with capacity and dropless."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh
    from repro.models import layers as JaxLyr

    cfg = jax_get_arch(arch).reduced().padded(4)
    p = JaxLyr.moe_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    sh = JaxLyr.Sharder(mesh=make_host_mesh(), axes={"batch": "data", "experts": "model",
                                                     "expert_ff": None})
    out = {"params": jax.tree.map(np.asarray, p), "x": x}
    for dropless in (False, True):
        y, aux = jax.jit(lambda p_, x_: JaxLyr.moe_sharded(p_, x_, cfg, sh,
                                                           dropless=dropless))(p, x)
        out[dropless] = (np.asarray(y), float(aux))
    return out


#: the reference's tensor parallelism on 4 host devices: moe_sharded and a
#: dense block on a (1, 4) mesh, from tp_inputs.npz; writes tp_outputs.npz
#: (or tp_error.txt when the reference raises)
REFERENCE_TP = r"""
import os, sys, traceback
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.models import layers as L
from repro.models.decoder import _dense_block
from repro.sharding.specs import make_plan
d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "tp_inputs.npz"), allow_pickle=True))
# the classic Mesh, whose axes are Auto: on this JAX jax.make_mesh (which
# repro/launch/mesh.py calls) makes Explicit axes, on which the Sharder's
# with_sharding_constraint raises (ROADMAP.md section 3)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
out = {}
try:
    assert len(jax.devices()) == 4
    for arch in ("granite-moe-3b-a800m", "llama4-scout-17b-a16e"):
        plan = make_plan(get_arch(arch).reduced(), mesh, regime="replica")
        p = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(arch + "/")}
        for dropless in (False, True):
            y, aux = jax.jit(lambda p_, x_: L.moe_sharded(
                p_, x_, plan.cfg, plan.sharder(), dropless=dropless))(p, inp["moe_x/" + arch])
            out[f"moe/{arch}/{dropless}"] = np.asarray(y)
            out[f"aux/{arch}/{dropless}"] = np.asarray(aux)
    plan = make_plan(get_arch("smollm-135m").reduced(), mesh)
    layer = {}
    for k, v in inp.items():
        if k.startswith("dense/"):
            node = layer
            *parents, leaf = k.split("/")[1:]
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(v)
    h = jnp.asarray(inp["dense_h"])
    pos = jnp.broadcast_to(jnp.arange(h.shape[1], dtype=jnp.int32), h.shape[:2])
    y, _ = jax.jit(lambda p_, h_: _dense_block(p_, h_, plan.cfg, plan.sharder(), pos, 0))(layer, h)
    out["dense"] = np.asarray(y)
    np.savez(os.path.join(d, "tp_outputs.npz"), **out)
except Exception:
    open(os.path.join(d, "tp_error.txt"), "w").write(traceback.format_exc())
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import get_arch

    base = tmp_path_factory.mktemp("tp")
    refs = {"cases": {}, "moe": {}, "data": {}}
    seen = {}
    for case in CASES:
        for W in WORLDS:
            jcfg = reduced(jax_get_arch, case).padded(W)
            key = repr(dataclasses.asdict(jcfg))
            if key not in seen:
                seen[key] = reference_case(jcfg, quant=case == QUANT_CASE)
            refs["cases"][(case, W)] = seen[key]
            assert dataclasses.asdict(reduced(get_arch, case).padded(W)) == \
                dataclasses.asdict(jcfg)
    for arch in MOE_ARCHS:
        refs["moe"][arch] = reference_moe(jax_get_arch, arch)
    for case in DATA_CASES:
        jcfg = reduced(jax_get_arch, case).padded(2)
        halves = [reference_case(jcfg, slice(r, r + 1)) for r in range(B)]
        refs["data"][case] = dict(
            halves=halves, params=halves[0]["params"],
            tokens=tokens_of(jcfg), embeds=embeds_of(jcfg),
            # the rows' caches side by side ([L, B, ...]; idx [L] is shared)
            prefill_caches=jax.tree.map(
                lambda *a: a[0] if a[0].ndim == 1 else np.concatenate(a, axis=1),
                *[h["prefill_caches"] for h in halves]),
            decode=[(np.concatenate([h["decode"][i][0] for h in halves]),
                     np.concatenate([h["decode"][i][1] for h in halves]), None)
                    for i in range(N_DECODE)])
    # the (1, 4) reference run's inputs: the MoE layers, smollm's first block
    dense_ref = refs["cases"][("smollm-135m", 4)]
    h = np.random.default_rng(5).standard_normal((B, S, dense_ref["params"]["embed"].shape[1])
                                                 ).astype(np.float32)
    refs["tp_inputs"] = {"dense_h": h}
    flat = {"dense_h": h}
    for path, a in _leaves(dense_ref["params"]["blocks"]):
        flat["dense/" + path] = a[0]
    for arch in MOE_ARCHS:
        for name, a in refs["moe"][arch]["params"].items():
            flat[f"{arch}/{name}"] = a
        flat["moe_x/" + arch] = refs["moe"][arch]["x"]
    np.savez(base / "tp_inputs.npz", **flat)
    torch.save(refs, base / "inputs.pt")
    # the reference's 4-device run goes on beside the worlds
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]))
    tp = subprocess.Popen([sys.executable, "-c", REFERENCE_TP, str(base)], env=env,
                          cwd=str(ROOT), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return dict(base=base, refs=refs, tp=tp)


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def spawn(base: Path, world: int) -> list:
    from repro_torch.core.sharded import spawn_world

    workdir = base / f"w{world}"
    workdir.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")])}
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
    return spawn(inputs["base"], 4)


@pytest.fixture(params=WORLDS, ids=["W2", "W4"])
def world(request):
    return request.param, request.getfixturevalue(f"world{request.param}")


@pytest.fixture(scope="module")
def reference_tp(inputs, world4):
    tp = inputs["tp"]
    out, _ = tp.communicate(timeout=300)
    assert tp.returncode == 0, out[-4000:]
    err = inputs["base"] / "tp_error.txt"
    if err.exists():
        return {"error": err.read_text()}
    return dict(np.load(inputs["base"] / "tp_outputs.npz"))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
def assert_close(port, ref, tol, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def cut(a, spec, coords, mesh_shape):
    """The reference's cache ``a`` cut by a spec of the reference (mesh
    axis names per dim) at ``coords``: each named dim split evenly."""
    idx = []
    for i, n in enumerate(a.shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        parts = mesh_shape[entry]
        idx.append(slice(coords[entry] * n // parts, (coords[entry] + 1) * n // parts))
    return a[tuple(idx)]


def ref_shards(tree, cfg, W, rank, batch, data=1):
    """The reference's caches cut for ``rank`` of a (data, W) mesh by
    repro/sharding/specs.py::cache_spec_for_path."""
    from repro.sharding.specs import cache_spec_for_path, make_plan

    plan = make_plan(cfg, ShapeMesh(data, W), regime="replica")
    coords = {"data": rank // W, "model": rank % W}
    out = {}
    for path, a in _leaves(tree):
        spec = tuple(cache_spec_for_path(path, a.ndim, plan, batch))
        out[path] = cut(a, spec, coords, {"data": data, "model": W})
    return out


def jcfg_of(case, W):
    from repro.configs import get_arch as jax_get_arch
    return reduced(jax_get_arch, case).padded(W)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(inputs, world, case):
    W, ranks = world
    ref = inputs["refs"]["cases"][(case, W)]
    for r, got in enumerate(ranks):
        logits, aux = got["cases"][case]["forward"]
        assert_close(logits, ref["forward"][0], REF_TOL.get(case, TOL),
                     f"{case} W={W} rank {r}")
        assert abs(aux - ref["forward"][1]) <= 1e-6 * max(1.0, abs(ref["forward"][1]))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_prefill_match_the_unsharded_port(world, case):
    """The tensor-parallel model against the unsharded port model of the
    same parameters (each rank's cache shard against the unsharded caches
    cut by the port's spec, as the reference's in the tests above)."""
    W, ranks = world
    for r, got in enumerate(ranks):
        g, u = got["cases"][case], got["cases"][case]["unsharded"]
        assert_close(g["forward"][0], u["forward"][0], TOL, f"{case} W={W} rank {r}")
        assert_close(g["prefill"][0], u["prefill"][0], TOL, f"{case} W={W} rank {r}")
        for i in range(N_DECODE):
            assert_close(g["decode"][i], u["decode"][i], TOL, f"{case} step {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_cache_shards_match_reference(inputs, world, case):
    W, ranks = world
    ref = inputs["refs"]["cases"][(case, W)]
    for r, got in enumerate(ranks):
        last, caches = got["cases"][case]["prefill"]
        tol = REF_TOL.get(case, TOL)
        assert_close(last, ref["prefill"], tol, f"{case} W={W} rank {r}")
        want = ref_shards(ref["prefill_caches"], jcfg_of(case, W), W, r, B)
        port = dict(_leaves(caches))
        assert port.keys() == want.keys()
        for path, a in want.items():
            assert port[path].dtype == a.dtype, path
            assert_close(port[path], a, tol, f"{case} W={W} rank {r} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_reference(inputs, world, case):
    W, ranks = world
    ref = inputs["refs"]["cases"][(case, W)]
    for r, got in enumerate(ranks):
        for i, (logits, (_, _, want)) in enumerate(zip(got["cases"][case]["decode"],
                                                       ref["decode"])):
            assert_close(logits, want, DECODE_TOL, f"{case} W={W} rank {r} step {i}")
        want = ref_shards(ref["decode_caches"], jcfg_of(case, W), W, r, B)
        port = dict(_leaves(got["cases"][case]["decode_caches"]))
        for path, a in want.items():
            assert_close(port[path], a, DECODE_TOL, f"{case} W={W} rank {r} {path}")


def test_ranks_logits_bit_equal(world):
    W, ranks = world
    for case in CASES:
        for key in ("forward", "prefill"):
            a = ranks[0]["cases"][case][key][0]
            assert all(np.array_equal(a, r["cases"][case][key][0]) for r in ranks), (case, key)
        for i in range(N_DECODE):
            a = ranks[0]["cases"][case]["decode"][i]
            assert all(np.array_equal(a, r["cases"][case]["decode"][i]) for r in ranks)


def test_kv_quant_decode_matches_reference(inputs, world):
    W, ranks = world
    ref = inputs["refs"]["cases"][(QUANT_CASE, W)]
    cfg = dataclasses.replace(jcfg_of(QUANT_CASE, W), kv_quant=True)
    for r, got in enumerate(ranks):
        steps, codes = got["quant"]
        differ = False
        for i, (logits, (_, _, want)) in enumerate(zip(steps, ref["quant_decode"])):
            cut_ref = ref_shards(ref["quant_codes"][i], cfg, W, r, B)
            for name in ("k", "v"):
                a, b = codes[i][name].astype(np.int32), cut_ref[name].astype(np.int32)
                assert np.abs(a - b).max() <= 1, (r, i, name)
                differ = differ or bool((a != b).any())
            tol = CODE_MISMATCH_TOL if differ else DECODE_TOL
            assert_close(logits, want, tol, f"{QUANT_CASE} W={W} rank {r} step {i}")


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_matches_reference_host_mesh(inputs, world, arch, dropless):
    W, ranks = world
    y_ref, aux_ref = inputs["refs"]["moe"][arch][dropless]
    for r, got in enumerate(ranks):
        y, aux = got["moe"][(arch, dropless)]
        assert_close(y, y_ref, TOL, f"{arch} W={W} rank {r}")
        assert abs(aux - aux_ref) <= 1e-6 * max(1.0, abs(aux_ref))


@pytest.mark.parametrize("case", DATA_CASES)
def test_data_and_model_mesh(inputs, world4, case):
    """A (2, 2) mesh: data rank i computes batch row i; every rank returns
    the whole batch's logits, equal to the reference's run on each row
    alone; each rank's caches hold its row."""
    ref = inputs["refs"]["data"][case]
    halves = ref["halves"]
    for r, got in enumerate(world4):
        g = got["data"][case]
        assert g["rows"] == slice(r // 2, r // 2 + 1)
        logits, aux = g["forward"]
        assert_close(logits, np.concatenate([h["forward"][0] for h in halves]), TOL,
                     f"{case} rank {r}")
        want_aux = np.mean([h["forward"][1] for h in halves])
        assert abs(aux - want_aux) <= 1e-6 * max(1.0, abs(want_aux))
        assert_close(g["prefill"][0], np.concatenate([h["prefill"] for h in halves]),
                     TOL, f"{case} rank {r} prefill")
        mine = halves[r // 2]
        want = ref_shards(mine["prefill_caches"], jcfg_of(case, 2), 2, r % 2, 1)
        for path, a in dict(_leaves(g["prefill"][1])).items():
            assert_close(a, want[path], TOL, f"{case} rank {r} {path}")
        for i in range(N_DECODE):
            assert_close(g["decode"][i],
                         np.concatenate([h["decode"][i][2] for h in halves]),
                         DECODE_TOL, f"{case} rank {r} step {i}")


@pytest.mark.parametrize("case", SERVER_CASES)
def test_slot_server_tokens_equal_the_unsharded_port(world, case):
    """launch/serve.py's SlotServer runs unchanged over the tensor-parallel
    model: every rank's greedy tokens are the unsharded model's."""
    W, ranks = world
    for r, got in enumerate(ranks):
        tp, plain = got["cases"][case]["server"]
        assert tp == plain, (case, W, r)


@pytest.mark.parametrize("case", DATA_CASES)
def test_slot_server_on_the_data_and_model_mesh(world4, case):
    """On the (2, 2) mesh each data rank's caches hold its slot (the
    admissions reset the global slot on the rank that holds it)."""
    for r, got in enumerate(world4):
        tp, plain = got["data"][case]["server"]
        assert tp == plain, (case, r)


def test_fsdp_over_a_data_axis_refuses(world4):
    """The fsdp regime over a data axis of 2 (it refused until the plan's
    training came): llama4-scout on the (2, 2) mesh, each rank holding its
    data half of every fsdp-split weight, gathers them per layer and serves
    each data rank's row as the unsharded port model does (MoE capacity
    counts the rank's tokens; the aux is the rows' mean)."""
    for r, got in enumerate(world4):
        f = got["fsdp"]
        assert_close(f["logits"], f["want"], TOL, f"rank {r}")
        assert abs(f["aux"] - f["want_aux"]) <= 1e-6 * max(1.0, abs(f["want_aux"]))
        halved = [n for n, s in f["shapes"].items() if s != f["full"][n]]
        assert "embed" in halved and "blocks.0.attn.wq" in halved
        assert f["counts"]["all_gather"]["by_axis"]["data"]["calls"] >= len(halved)


def test_collectives_a_layer(world):
    """Each attention or MLP layer ends in one sum over "model", the
    embedding in one, the unembed in one all-gather (a layer in the
    gather GQA mode that reads outside its slots adds two all-gathers: K
    and V)."""
    W, ranks = world
    for case in ("smollm-135m", "granite-moe-3b-a800m"):
        c = ranks[0]["counts"][case]
        # forward, prefill, 4 decode steps: 2 layers x 2 sums + the
        # embedding's, one logits all-gather each
        assert c["all_reduce"]["calls"] == 6 * (2 * 2 + 1), (case, W, c)
        assert c["all_gather"]["calls"] == 6, (case, W, c)


def test_reference_tensor_parallel_run(inputs, world4, reference_tp):
    """The reference's moe_sharded and dense block on a (1, 4) mesh of 4
    host devices against the port's world of 4."""
    if "error" in reference_tp:
        pytest.fail("the reference's (1, 4) run raised:\n" + reference_tp["error"])
    for arch in MOE_ARCHS:
        for dropless in (False, True):
            for r, got in enumerate(world4):
                y, aux = got["moe"][(arch, dropless)]
                assert_close(y, reference_tp[f"moe/{arch}/{dropless}"], TOL, (arch, r))
                want = float(reference_tp[f"aux/{arch}/{dropless}"])
                assert abs(aux - want) <= 1e-6 * max(1.0, abs(want))
    for r, got in enumerate(world4):
        assert_close(got["dense_block"], reference_tp["dense"], TOL, f"rank {r}")


# ---------------------------------------------------------------------------
# a world of one, in this process
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


@torch.inference_mode()
@pytest.mark.parametrize("case", list(CASES))
def test_world_of_one_is_the_unsharded_model_bit_for_bit(host_mesh, case):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    cfg = reduced(get_arch, case)
    plan = make_plan(cfg, host_mesh)
    assert plan.cfg == cfg and host_mesh.shape == {"data": 1, "model": 1}
    plain = build_model(cfg, device="cpu", seed=0)
    tp = build_model(plan.cfg, device="cpu", seed=0, sh=plan.sharder())
    for (n, a), (m, b) in zip(plain.state_dict().items(), tp.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    tok, emb = torch.from_numpy(tokens_of(cfg)), embeds_of(cfg)
    emb = None if emb is None else torch.from_numpy(emb)
    for a, b in zip(plain(tok, emb), tp(tok, emb)):
        assert torch.equal(a, b)
    (la, ca), (lb, cb) = plain.prefill(tok, emb, S + PAD), tp.prefill(tok, emb, S + PAD)
    assert torch.equal(la, lb)
    t = la.argmax(-1, keepdim=True).int()
    for i in range(N_DECODE):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        (x, ca), (y, cb) = plain.decode_step(ca, t, pos), tp.decode_step(cb, t, pos)
        assert torch.equal(x, y), i
        t = x.argmax(-1, keepdim=True).int()
    for (p, a), (q, b) in zip(_leaves(ca.tree), _leaves(cb.tree)):
        assert p == q and torch.equal(a, b), p
    assert tp.sh.counts["all_reduce"]["calls"] > 0
    reqs = [[Request(i, tokens_of(cfg, 1, seed=i)[0, :6], 3) for i in range(3)]
            for _ in range(2)]
    for model, rq in zip((plain, tp), reqs):
        SlotServer(model, 2, 12, device="cpu").run(rq)
    assert [r.out for r in reqs[0]] == [r.out for r in reqs[1]]


def test_training_refuses_under_a_mesh(host_mesh):
    """Training under a (1, 1) mesh (it refused until the plan's training
    came) is the unsharded model's, bit for bit: ``loss``,
    ``forward_hidden`` and the train step's new parameters, r and loss.
    Federated training of a model built under a mesh still refuses: the
    reference's FL round is replicated over "model"."""
    from repro_torch.configs import get_arch
    from repro_torch.core.lm import make_lm_clients, make_lm_problem
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.decoder import build_model
    from repro_torch.sharding.specs import make_plan

    plan = make_plan(get_arch("smollm-135m").reduced(), host_mesh)
    model = build_model(plan.cfg, device="cpu", sh=plan.sharder())
    plain = build_model(plan.cfg, device="cpu")
    tok = torch.from_numpy(tokens_of(plan.cfg))
    assert torch.equal(model.loss(tok), plain.loss(tok))
    assert torch.equal(model.forward_hidden(tok)[0], plain.forward_hidden(tok)[0])
    params = {n: t.detach().clone() for n, t in plain.named_parameters()}
    corr = {n: torch.full_like(t, 1e-3) for n, t in params.items()}
    got = make_train_step(model, eta=0.1)(params, {"tokens": tok}, corr)
    want = make_train_step(plain, eta=0.1)(params, {"tokens": tok}, corr)
    assert torch.equal(got[2], want[2])
    for i in (0, 1):
        for n in params:
            assert torch.equal(got[i][n], want[i][n]), n
    clients = make_lm_clients(tokens_of(plan.cfg, 4), 2, device="cpu")
    with pytest.raises(NotImplementedError, match='replicated over the "model"'):
        make_lm_problem(model, clients)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    child(Path(sys.argv[1]))
    sys.exit(0)
