"""The port's MoE family (models/layers.py::moe, the decoder's MoEBlock)
against the JAX package's, on the CPU at the reduced sizes, in f32, from
the reference's parameters (converted with ``convert``).

* The layer against ``repro.models.layers.moe`` on the reduced granite
  (E=4, k=2) and the reduced Scout (E=4, k=1), by capacity and dropless,
  with padded (dummy) experts, with a capacity small enough that tokens
  drop, and with a zero router (every probability tied): the output within
  1e-5 of the reference's largest |y|, the aux loss within 1e-6, and the
  routing equal: the top-k experts of every token and the kept mask of
  every assignment (so the same tokens drop).
* forward (logits and aux), prefill and 4 decode steps of both configs:
  test_torch_lm.py's tests and tolerances on this module's ``lm`` fixture.
* The loss and its flat gradient of both configs at test_torch_lm_train's
  tolerances (rel 1e-5, 1e-4 of the largest magnitude).
* A bf16 MoE model keeps its f32 router through ``convert`` both ways.

The federated rounds on the MoE LM are in test_torch_moe_rounds.py (a file
of their own, so that the driver's ``--dist loadfile`` spreads the two).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JaxLyr
from repro.models.decoder import build_model as jax_build_model
from repro.models.layers import Sharder
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.core.lm import flatten_params
from repro_torch.models import layers as Lyr
from repro_torch.models.decoder import build_model

import test_torch_lm
import test_torch_lm_train
from jax_compile import compiled
from test_torch_lm import (test_decode_steps_match_reference,  # noqa: F401
                           test_forward_matches_reference,
                           test_prefill_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

GRANITE, SCOUT = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
MOE_CONFIGS = {GRANITE: (GRANITE, None), SCOUT: (SCOUT, None)}
#: layer cases: id -> (arch, dropless, config changes, zero router)
LAYER_CASES = {
    "granite-capacity": (GRANITE, False, {}, False),
    "granite-dropless": (GRANITE, True, {}, False),
    "scout-capacity": (SCOUT, False, {}, False),
    "scout-dropless": (SCOUT, True, {}, False),
    "granite-padded-experts": (GRANITE, False, {"padded_experts": 6}, False),
    "granite-drops": (GRANITE, False, {"capacity_factor": 0.5}, False),
    "scout-drops": (SCOUT, False, {"capacity_factor": 0.5}, False),
    "granite-tied-router": (GRANITE, False, {}, True),
}
B, S = 2, 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def reference_routing(p, x, cfg, dropless):
    """The routing of the reference's ``moe`` (repro/models/layers.py:478-505),
    which it does not return: the top-k experts [T, k] and the kept mask
    [T·k]."""
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    E, k = cfg.eff_experts, cfg.experts_per_token
    logits = x.reshape(T, d).astype(jnp.float32) @ p["router"]
    if E != cfg.num_experts:
        logits = jnp.where((jnp.arange(E) >= cfg.num_experts)[None, :], -1e30, logits)
    _, gate_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    capacity = T * k if dropless else max(int(cfg.capacity_factor * T * k / E), 1)
    flat_e = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - 1)[jnp.arange(T * k), flat_e]
    return gate_i, pos < capacity


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference(case):
    arch, dropless, changes, zero_router = LAYER_CASES[case]
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    key = jax.random.PRNGKey(0)
    p = compiled(lambda k_: JaxLyr.moe_init(k_, jcfg, jnp.float32), key)(key)
    if zero_router:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    ref_y, ref_aux = compiled(
        lambda p_, x_: JaxLyr.moe(p_, x_, jcfg, Sharder(), dropless=dropless), p, x)(p, x)
    ref_gate_i, ref_keep = compiled(
        lambda p_, x_: reference_routing(p_, x_, jcfg, dropless), p, x)(p, x)

    pp = Lyr.Params({name: convert.tensor(a, "cpu") for name, a in _np(p).items()})
    xt = torch.from_numpy(np.array(x))
    with torch.inference_mode():
        y, aux = Lyr.moe(pp, xt, cfg, dropless=dropless)
        _, gate_i, _, _, _, keep, capacity = Lyr.moe_route(
            pp, xt.reshape(B * S, -1), cfg, dropless)
    np.testing.assert_array_equal(gate_i.numpy(), np.asarray(ref_gate_i))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    dropped = int((~keep).sum())
    if "drops" in case or zero_router:
        assert dropped > 0, (case, capacity)
    if dropless:
        assert dropped == 0 and capacity == B * S * cfg.experts_per_token
    ref_y = np.asarray(ref_y)
    err = np.abs(y.numpy().astype(np.float64) - ref_y).max()
    assert err <= 1e-5 * np.abs(ref_y).max(), (case, err, np.abs(ref_y).max())
    assert abs(float(aux) - float(ref_aux)) <= 1e-6, (case, float(aux), float(ref_aux))
    if changes.get("padded_experts"):
        assert (gate_i < cfg.num_experts).all()


@pytest.fixture(scope="module", params=list(MOE_CONFIGS))
def lm(request):
    """test_torch_lm.py's reference results on the MoE configs."""
    return test_torch_lm.reference_results(request.param, MOE_CONFIGS)


@pytest.mark.parametrize("arch", list(MOE_CONFIGS))
def test_loss_and_gradient_match_reference(arch):
    test_torch_lm_train.check_loss_and_gradient(arch, arch, None, 128)


def test_bf16_model_keeps_an_f32_router():
    jcfg = dataclasses.replace(jax_get_arch(GRANITE).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(GRANITE).reduced(), dtype="bfloat16")
    key = jax.random.PRNGKey(0)
    params = _np(compiled(jax_build_model(jcfg).init, key)(key))
    model = build_model(cfg, device="cpu")
    moe = model.blocks[0].moe
    assert moe["router"].dtype == torch.float32 and moe["wi_gate"].dtype == torch.bfloat16
    model.load_state_dict(convert.lm_params(params, cfg, "cpu"))
    for l, block in enumerate(model.blocks):
        for name in ("router", "wi_gate", "wi_up", "wo"):
            want = params["blocks"]["moe"][name][l]
            got = block.moe[name]
            assert str(got.dtype)[6:] == want.dtype.name, (name, got.dtype, want.dtype)
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    back = convert.lm_unflat_params(flatten_params(model), model)
    for name in ("router", "wi_gate", "wi_up", "wo"):
        want = params["blocks"]["moe"][name]
        got = back["blocks"]["moe"][name]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(np.float32))
    assert back["blocks"]["moe"]["router"].dtype == np.float32
    with torch.inference_mode():
        logits, aux = model(torch.zeros((1, 8), dtype=torch.int32))
    assert logits.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
