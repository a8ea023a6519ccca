"""The port's sharding plan (repro_torch/sharding/specs.py) against the
reference's (repro/sharding/specs.py), on shape-only meshes (no process
group, no devices), for every architecture at its published size:

  * ``make_plan``: the padded config, the regime and the logical axes, for
    every arch x {single pod, multi-pod} x {2, 4, 16} model shards, on a
    mesh whose data (and pod) axes have one rank; on a 16-rank data axis
    every arch's plan too, the fsdp archs' in their own regime (whose
    weights the data axis also splits) and with ``regime="replica"``;
  * every parameter's spec, matched by path: the port's state-dict names
    (a small model of the same structure gives them) against the
    reference's leaves of the padded model (``jax.eval_shape``), a stacked
    leaf's spec without its layer axis; the two sets of paths are equal;
  * every cache tensor's spec (``init_caches``'s tree, dense, int8 and
    hybrid) for a batch that divides the data axis and one that does not;
  * the ``gather`` GQA map: for each arch and 2, 4, 8 and 16 model ranks,
    which ranks' query heads read KV heads outside their own KV slots (and
    so gather the KV heads over "model"), pinned, and derived again from
    the reference's head map and axes.
"""
import dataclasses

import jax
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.models.decoder import build_model as jax_build_model
from repro.sharding import specs as ref_specs
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models.decoder import build_model
from repro_torch.models.layers import Sharder, kv_outside, kv_read
from repro_torch.sharding import specs

from torch_threads import one_torch_thread  # noqa: F401

SHARDS = (2, 4, 16)


class FakeMesh:
    """Shape-only mesh (tests/test_sharding.py's), with this rank's place."""

    def __init__(self, model, data=1, multi_pod=False, coords=None):
        self.shape = ({"pod": 1 if data == 1 else 2, "data": data, "model": model}
                      if multi_pod else {"data": data, "model": model})
        self.coords = coords or {}


def spec_tuple(p) -> tuple:
    return tuple(p)


def small(cfg):
    """A CPU-sized model config of ``cfg``'s structure: the same parameter
    names (a hybrid config keeps its trailing Mamba-2 group)."""
    r = cfg.reduced()
    if cfg.family == "hybrid":
        r = dataclasses.replace(r, num_layers=3)
    return r


@pytest.fixture(scope="module")
def port_names():
    """Each arch's port state-dict names and ranks, and its caches' tree."""
    out = {}
    for arch in ARCHS:
        m = build_model(small(get_arch(arch)), device="cpu")
        out[arch] = (dict(m.named_parameters()),
                     m.init_caches(4, 8, "cpu").tree,
                     m.cfg)
    return out


def plans(arch, W, multi_pod, data=1, regime=None):
    mesh = FakeMesh(W, data, multi_pod)
    return (specs.make_plan(get_arch(arch), mesh, multi_pod, regime),
            ref_specs.make_plan(jax_get_arch(arch), mesh, multi_pod, regime))


def test_archs_are_the_references():
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("W", SHARDS)
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_param_specs_equal_the_reference(arch, multi_pod, W, port_names):
    plan, ref = plans(arch, W, multi_pod)
    assert dataclasses.asdict(plan.cfg) == dataclasses.asdict(ref.cfg)
    assert plan.regime == ref.regime and plan.axes == ref.axes
    assert plan.model_shards == ref.model_shards == W
    # every leaf of the reference's padded model, by path
    p_shape = jax.eval_shape(jax_build_model(ref.cfg).init, jax.random.PRNGKey(0))
    ref_leaves = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(p_shape)[0]:
        path = "/".join(k.key for k in kp)
        ref_leaves[path] = (leaf.ndim,
                            spec_tuple(ref_specs.param_spec_for_path(path, leaf.ndim, ref)))
    names, _, _ = port_names[arch]
    ported = specs.param_specs(names, plan)
    seen = set()
    for name, spec in ported.items():
        path, stacked = specs.reference_path(name)
        ndim, want = ref_leaves[path]
        assert names[name].ndim == ndim - stacked, name
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(path)
    assert seen == set(ref_leaves)


@pytest.mark.parametrize("W", SHARDS)
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, multi_pod, W, port_names):
    plan, ref = plans(arch, W, multi_pod)
    _, tree, _ = port_names[arch]
    m = jax_build_model(ref.cfg)
    for batch in (4, 3):
        c_shape = jax.eval_shape(lambda: m.init_caches(batch, 8))
        want = jax.tree.map(spec_tuple, ref_specs.cache_specs(c_shape, ref, batch),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert specs.cache_specs(tree, plan, batch) == want
        assert specs.batch_axis(plan, batch) == ref_specs.batch_axis(ref, batch)
    if get_arch(arch).num_heads:
        # the int8 cache's scales
        q = build_model(dataclasses.replace(small(get_arch(arch)), kv_quant=True),
                        device="cpu").init_caches(4, 8, "cpu").tree
        kv = q["shared_kv"] if "shared_kv" in q else q
        got = specs.cache_specs(kv, plan, 4)
        assert got["k_scale"] == got["v_scale"] == got["k"] == (
            None, "data" if not multi_pod else ("pod", "data"), None,
            plan.axes["kv_heads"], None)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_of_sixteen(arch, port_names):
    """On a (16, 16) mesh every arch plans as the reference does: the
    fsdp archs in the fsdp regime (the data axis splits their weights too)
    and with regime="replica"."""
    regimes = [None, "replica"] if arch in specs.FSDP_ARCHS else [None]
    for regime in regimes:
        plan, ref = plans(arch, 16, False, data=16, regime=regime)
        want_regime = "fsdp" if arch in specs.FSDP_ARCHS and regime is None else "replica"
        assert plan.regime == ref.regime == want_regime
        assert plan.axes == ref.axes
        names, tree, _ = port_names[arch]
        for name, spec in specs.param_specs(names, plan).items():
            path, stacked = specs.reference_path(name)
            want = spec_tuple(ref_specs.param_spec_for_path(
                path, names[name].ndim + stacked, ref))
            assert spec == want[stacked:], (name, regime)
    assert specs.batch_axis(plan, 32) == ref_specs.batch_axis(ref, 32) == "data"
    assert specs.batch_axis(plan, 8) is ref_specs.batch_axis(ref, 8) is None


#: (arch, model ranks) -> the ranks whose query heads read KV heads outside
#: their own KV slots in the gather GQA mode (and all-gather K and V over
#: "model"); every other (arch, ranks) reads its own slots
GATHERED = {("smollm-135m", 2): [1], ("smollm-135m", 4): [3],
            ("smollm-135m", 8): [1, 2, 3, 4, 5, 6, 7],
            ("smollm-135m", 16): [1, 2, 3, 4, 5, 6, 7, 8],
            ("llama4-scout-17b-a16e", 16): list(range(1, 16)),
            ("granite-moe-3b-a800m", 16): list(range(1, 16))}


@pytest.mark.parametrize("W", (2, 4, 8, 16))
@pytest.mark.parametrize("arch", [a for a in ARCHS if get_arch(a).num_heads])
def test_gather_map_stays_in_each_ranks_kv_slots(arch, W):
    plan, ref = plans(arch, W, False)
    cfg = ref.cfg
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    mode = jax_gqa_mode(cfg)
    # the reference's head map (layers.py:294-297) or the grouped one
    if mode == "gather":
        m = [(i * cfg.num_kv_heads) // cfg.num_heads if i < cfg.num_heads else i % KV
             for i in range(H)]
    else:
        m = [i // (H // KV) for i in range(H)]
    kv_split = ref.axes["kv_heads"] == "model"
    outside = []
    for r in range(W):
        heads = range(r * H // W, (r + 1) * H // W)
        kv0, kv1 = (r * KV // W, (r + 1) * KV // W) if kv_split else (0, KV)
        if not all(kv0 <= m[i] < kv1 for i in heads):
            outside.append(r)
        sh = Sharder(mesh=FakeMesh(W, coords={"data": 0, "model": r}), axes=plan.axes)
        how, got_heads, _ = kv_read(plan.cfg, sh)
        assert got_heads == heads
        # the all-gather is collective: every rank takes part where any
        # rank reads outside its slots
        assert (how == "gathered") == bool(GATHERED.get((arch, W))), (arch, W, r, how)
        # the grouped map reads the held slots as they are (flash's GQA)
        assert (how == "as_is") == (mode == "grouped"), (arch, W, r, how)
    assert outside == GATHERED.get((arch, W), []), (arch, W, outside)
    if mode == "gather":
        assert kv_outside(plan.cfg, W, W if kv_split else 1) == outside


def jax_gqa_mode(cfg):
    from repro.models.layers import gqa_mode
    return gqa_mode(cfg)
