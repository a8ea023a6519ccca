"""The ``gather`` GQA mode of padded configs (models/layers.py::kv_map,
``_gather_kv``) against the JAX package's, on the CPU at the reduced
sizes, in f32, from the reference's parameters (converted with
``convert.lm_params``).

Configs: the reduced smollm-135m padded(8) (the reference's own no-op
case: 4 heads on 2 KV heads become 8 on 8) and the reduced musicgen-medium
made MHA (4 heads on 4, as the published model is 24 on 24) padded(16):
16 heads on 16, and the vocabulary padded 1024 -> 2048. Both are in the
``gather`` mode, as musicgen-medium.padded(16) is at full width.

* ``gqa_mode`` equals the reference's for every registry config padded to
  1, 2, 4, 8 and 16, and ``kv_map`` its list.
* One attention layer against the reference's at S = 64 (its materialized
  softmax) and S = 1024 (its blocked path), by the serving path (the flash
  kernel's plain version on the CPU) and the training path: within 1e-5
  of the reference's largest magnitude.
* forward, prefill (with musicgen's frontend embeddings) and 4 decode
  steps: test_torch_lm.py's tests and tolerance on this module's ``lm``
  fixture; the loss and its gradient at S = 128 (and S = 1024 for smollm):
  test_torch_lm_train.py's check.
* Padded heads are no-ops: zeroing the padded query heads' ``wq``
  columns, or redrawing the padded KV heads' ``wk``/``wv`` columns, moves
  the layer's output by at most 1e-6 of its largest magnitude (the
  reference's test_padded_heads_are_noops, which holds the first).
* ``attn_init`` lays padded heads out as the reference's: zero ``wo``
  rows, the replicated-kv layout only in the grouped mode.
* ``lm_params`` loads the reference's padded parameters, ``wq``, ``wk``,
  ``wv`` and ``wo`` at the padded head counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.registry import ARCHS
from repro.models import layers as JaxLyr
from repro.models.decoder import build_model as jax_build_model
from repro.models.layers import Sharder
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.models import layers as Lyr
from repro_torch.models.decoder import build_model

import test_torch_lm
import test_torch_lm_train
from jax_compile import compiled
from test_torch_lm import (test_decode_steps_match_reference,  # noqa: F401
                           test_forward_matches_reference,
                           test_prefill_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401


def smollm_p8(cfg):
    return cfg.padded(8)


def musicgen_mha_p16(cfg):
    return dataclasses.replace(cfg, num_kv_heads=cfg.num_heads).padded(16)


GATHER_CONFIGS = {"smollm-135m-p8": ("smollm-135m", None, smollm_p8),
                  "musicgen-medium-mha-p16": ("musicgen-medium", None, musicgen_mha_p16)}
LAYER_TOL = 1e-5
NOOP_TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(GATHER_CONFIGS))
def lm(request):
    """test_torch_lm.py's reference results on the padded configs."""
    return test_torch_lm.reference_results(request.param, GATHER_CONFIGS)


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
def test_gqa_mode_matches_reference(shards):
    modes = set()
    for arch in ARCHS:
        jcfg, cfg = jax_get_arch(arch).padded(shards), get_arch(arch).padded(shards)
        assert (cfg.eff_heads, cfg.eff_kv_heads) == (jcfg.eff_heads, jcfg.eff_kv_heads)
        if not cfg.num_heads:
            continue
        mode = Lyr.gqa_mode(cfg)
        assert mode == JaxLyr.gqa_mode(jcfg), (arch, shards)
        modes.add(mode)
        want = [(i * cfg.num_kv_heads) // cfg.num_heads if i < cfg.num_heads
                else i % cfg.eff_kv_heads for i in range(cfg.eff_heads)]
        assert Lyr.kv_map(cfg, "cpu").tolist() == want, (arch, shards)
    assert "grouped" in modes
    if shards == 16:
        # musicgen-medium (24 -> 32 heads on 24 -> 32) is one of them
        assert Lyr.gqa_mode(get_arch("musicgen-medium").padded(16)) == "gather"


def layer_case(name, S, seed=0):
    """One attention layer of the padded config, the reference's and the
    port's on the same parameters, and an input [2, S, d]."""
    _, _, change = GATHER_CONFIGS[name]
    arch = GATHER_CONFIGS[name][0]
    jcfg, cfg = change(jax_get_arch(arch).reduced()), change(get_arch(arch).reduced())
    assert Lyr.gqa_mode(cfg) == JaxLyr.gqa_mode(jcfg) == "gather"
    key = jax.random.PRNGKey(seed)
    p = compiled(lambda k_: JaxLyr.attn_init(k_, jcfg, jnp.float32), key)(key)
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pp = Lyr.Params({n: convert.tensor(a, "cpu") for n, a in _np(p).items()})
    return jcfg, cfg, p, pp, x


def _positions(S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("name", list(GATHER_CONFIGS))
def test_attention_layer_matches_reference(name, S):
    jcfg, cfg, p, pp, x = layer_case(name, S)
    pos = _positions(S)
    xj, pj = jnp.asarray(x), jnp.asarray(pos)
    ref = np.asarray(compiled(lambda p_, x_, q_: JaxLyr.attention(p_, x_, jcfg, Sharder(), q_)[0],
                              p, xj, pj)(p, xj, pj))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos.copy())
    with torch.inference_mode():
        serve, k, v = Lyr.attention(pp, xt, cfg, pt)
        train = Lyr.attention(pp, xt, cfg, pt, train=True)[0]
    assert k.shape == (2, S, cfg.eff_kv_heads, cfg.resolved_head_dim)
    for what, got in (("serving", serve), ("training", train)):
        err = np.abs(got.numpy().astype(np.float64) - ref).max()
        assert err <= LAYER_TOL * np.abs(ref).max(), (name, S, what, err)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(GATHER_CONFIGS))
@torch.inference_mode()
def test_padded_heads_are_noops(name, train):
    _, cfg, _, pp, x = layer_case(name, 64)
    pos, xt = torch.from_numpy(_positions(64).copy()), torch.from_numpy(x)
    hd, Ht, KVt = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    assert (pp["wo"][Ht * hd:] == 0).all()
    base = Lyr.attention(pp, xt, cfg, pos, train=train)[0]
    zero_q = dict(pp._parameters)
    zero_q["wq"] = pp["wq"].clone()
    zero_q["wq"][:, Ht * hd:] = 0
    gen = torch.Generator().manual_seed(1)
    redrawn = dict(pp._parameters)
    for n in ("wk", "wv"):
        redrawn[n] = pp[n].clone()
        redrawn[n][:, KVt * hd:] = torch.randn(redrawn[n][:, KVt * hd:].shape,
                                               generator=gen)
    for what, params in (("padded q heads zeroed", zero_q),
                         ("padded kv heads redrawn", redrawn)):
        got = Lyr.attention(Lyr.Params(params), xt, cfg, pos, train=train)[0]
        err = float((got - base).abs().max())
        assert err <= NOOP_TOL * float(base.abs().max()), (name, what, err)


@pytest.mark.parametrize("name,S", [("smollm-135m-p8", 128),
                                    ("musicgen-medium-mha-p16", 128),
                                    ("smollm-135m-p8", 1024)])
def test_loss_and_gradient_match_reference(name, S):
    arch, layers, change = GATHER_CONFIGS[name]
    test_torch_lm_train.check_loss_and_gradient(name, arch, layers, S, change)


@pytest.mark.parametrize("mode,arch,shards", [("gather", "musicgen-medium", 16),
                                               ("grouped", "internvl2-76b", 4)])
def test_attn_init_layout_matches_reference(mode, arch, shards):
    """The port's own attn_init lays out padded heads as the reference's
    (layers.py:126-155): zero wo rows for padded query heads, and the
    replicated-kv layout (each true KV head repeated KV/KVt times) only in
    the grouped mode; in the gather mode every KV head is its own draw."""
    change = musicgen_mha_p16 if arch == "musicgen-medium" else (lambda c: c.padded(shards))
    jcfg, cfg = change(jax_get_arch(arch).reduced()), change(get_arch(arch).reduced())
    assert Lyr.gqa_mode(cfg) == JaxLyr.gqa_mode(jcfg) == mode
    key = jax.random.PRNGKey(0)
    ref = _np(compiled(lambda k_: JaxLyr.attn_init(k_, jcfg, jnp.float32), key)(key))
    port = Lyr.attn_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    d, hd, Ht = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    KV, KVt = cfg.eff_kv_heads, cfg.num_kv_heads
    # gather: heads and KV heads padded; grouped: KV heads only (4 on 2 -> 4)
    assert KV > KVt and (cfg.eff_heads > Ht) == (mode == "gather")
    for p in (ref, {n: t.numpy() for n, t in port._parameters.items()}):
        assert {n: a.shape for n, a in p.items()} == {n: a.shape for n, a in ref.items()}
        assert (p["wo"][Ht * hd:] == 0).all() and (p["wo"][:Ht * hd] != 0).all(1).any()
        for w in (p["wk"], p["wv"]):
            heads = w.reshape(d, KV, hd)
            repeated = (heads == np.repeat(heads[:, ::KV // KVt], KV // KVt, axis=1)).all()
            assert repeated == (mode == "grouped"), (mode, repeated)


@pytest.mark.parametrize("name", list(GATHER_CONFIGS))
def test_lm_params_load_padded_heads(name):
    jcfg, cfg = test_torch_lm._configs(name, GATHER_CONFIGS)
    key = jax.random.PRNGKey(0)
    params = _np(compiled(jax_build_model(jcfg).init, key)(key))
    sd = convert.lm_params(params, cfg, "cpu")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    assert (H, KV) != (cfg.num_heads, cfg.num_kv_heads)
    for l in range(cfg.num_layers):
        assert sd[f"blocks.{l}.attn.wq"].shape == (d, H * hd)
        assert sd[f"blocks.{l}.attn.wk"].shape == sd[f"blocks.{l}.attn.wv"].shape == (d, KV * hd)
        assert sd[f"blocks.{l}.attn.wo"].shape == (H * hd, d)
    assert sd["embed"].shape == (cfg.eff_vocab, d)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    for l, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.attn["wq"].numpy(),
                                      params["blocks"]["attn"]["wq"][l])
