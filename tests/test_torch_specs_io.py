"""launch/specs_io.py against the reference's (repro/launch/specs_io.py),
with no process group and no memory:

  * ``effective_cfg``, ``cache_len_for`` and ``batch_specs_for`` (shapes
    and dtypes) equal the reference's for every arch x input shape (40
    pairs);
  * ``params_shape``: every arch's per-rank parameters, built on the meta
    device under the plan of the 16 x 16 and 2 x 16 x 16 production
    meshes (rank 0; an even split gives every rank these shapes), equal the
    reference's ``jax.eval_shape`` of its padded model cut by its
    ``param_specs``, leaf by leaf (a stacked leaf once per layer), shape
    and dtype; and they hold no storage.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs_io as ref_io
from repro.models.decoder import build_model as jax_build_model
from repro.sharding import specs as ref_specs
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.launch import specs_io
from repro_torch.launch.mesh import Mesh
from repro_torch.models.decoder import build_model
from repro_torch.sharding import specs

from torch_threads import one_torch_thread  # noqa: F401

PAIRS = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _shapes(tree) -> dict:
    """(shape, dtype name) of every leaf of a nested dict of tensors or
    ShapeDtypeStructs, by '/'-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _shapes(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_effective_cfg_cache_len_and_batch_specs(arch, shape):
    cfg = specs_io.effective_cfg(get_arch(arch), get_shape(shape))
    ref = ref_io.effective_cfg(jax_get_arch(arch), jax_get_shape(shape))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert specs_io.cache_len_for(cfg, get_shape(shape)) == \
        ref_io.cache_len_for(ref, jax_get_shape(shape))
    got = _shapes(specs_io.batch_specs_for(cfg, get_shape(shape)))
    assert got == _shapes(ref_io.batch_specs_for(ref, jax_get_shape(shape)))
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        specs_io.batch_specs_for(cfg, get_shape(shape))))


@pytest.fixture(scope="module")
def reference_leaves():
    """Each arch's reference parameter leaves of its config padded for 16
    model shards (what both production meshes plan), by '/'-joined path."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_arch(arch).padded(16)
        p = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
        out[arch] = p
    return out


def _cut(shape, spec, mesh_shape) -> tuple:
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(n // int(np.prod([mesh_shape.get(a, 1) for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_is_the_reference_cut_by_its_specs(arch, mesh, reference_leaves):
    shape = MESHES[mesh]
    multi_pod = "pod" in shape
    plan = specs.make_plan(get_arch(arch), Mesh(shape, {}, 0), multi_pod)
    model = build_model(plan.cfg, device="meta", sh=plan.sharder())
    got = specs_io.params_shape(model)
    assert all(t.device.type == "meta" for t in got.values())

    class ShapeMesh:
        pass
    ShapeMesh.shape = shape
    ref_plan = ref_specs.make_plan(jax_get_arch(arch), ShapeMesh, multi_pod)
    assert ref_plan.regime == plan.regime
    leaves = _shapes(reference_leaves[arch])
    ref_specs_tree = ref_specs.param_specs(reference_leaves[arch], ref_plan)
    spec_of = dict(zip(
        ["/".join(k.key for k in kp) for kp, _ in
         jax.tree_util.tree_flatten_with_path(reference_leaves[arch])[0]],
        jax.tree.leaves(ref_specs_tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))))
    seen = set()
    for name, t in got.items():
        path, stacked = specs.reference_path(name)
        full, dtype = leaves[path]
        spec = tuple(spec_of[path])
        want = _cut(full[1:] if stacked else full, spec[1:] if stacked else spec, shape)
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == (want, dtype), name
        seen.add(path)
    assert seen == set(leaves)
