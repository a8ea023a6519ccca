"""The int8 KV cache (``kv_quant``: models/layers.py::quantize_kv, the
quantized decode branch, ``init_kv_cache(quant=True)``) against the JAX
package's, on the CPU at the reduced sizes, in f32, from the reference's
parameters (converted with ``convert.lm_params``).

* ``quantize_kv``'s codes and scales equal the jitted reference
  ``_quantize_kv``'s bit for bit: random rows of many magnitudes, rows
  whose values sit on ties at .5 of a step (round half to even), all-zero
  rows (scale 1e-8) and bf16 input. The reference's compiled scale is
  max|x|·fl(1/127), not the quotient max|x|/127 (XLA turns a division by a
  constant into a product by its reciprocal); the port computes that
  product, and the test shows the two differ on some of these rows.
* Decode from ``init_caches`` (int8) for the dense (reduced smollm-135m),
  moe (reduced granite-moe-3b-a800m) and hybrid (the 5-layer reduced
  zamba2-7b) families, 12 teacher-forced steps through a ring of 8 slots
  (the ring wraps), and the dense one with a sliding window of 6. After
  every step the caches' int8 codes within one step of the reference's
  and equal in all but 1% of the entries, the scales (and SSM states)
  within 1e-4 of the largest, pos and idx equal. A code differs where the
  port's k or v (which differs from the reference's in summation order,
  ~1e-7 relative; ~1e-5 after the hybrid's SSM layers) lies that close to
  a rounding boundary of round(x/scale). The step's logits within 1e-4 of
  the reference's largest |logit| while every code is equal; once one
  differs (a k or v element off by one step, max|x|/127), within 1e-2
  (the differing codes move them by up to ~1e-3 here).
* Decode after a prefill: the prefill's caches stay in the model dtype (no
  scales) with ``kv_quant``, as the reference's ``pad_kv`` writes them,
  and 4 decode steps from them match the reference's.
* ``convert.lm_caches`` takes the reference's int8 caches (int8 codes, f32
  scales) and decoding goes on from them as the reference's does.
* The slot server's greedy tokens equal the reference ``SlotServer``'s
  with int8 caches; ``reset_slot`` zeroes an int8 slot's scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotServer as JaxSlotServer
from repro.models import layers as JaxLyr
from repro.models.decoder import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.models import layers as Lyr
from repro_torch.models.decoder import build_model

from jax_compile import compiled
from test_torch_lm import assert_close
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
#: the share of int8 codes that may differ (by one step) from the
#: reference's: each is a value within the two sides' difference of a
#: rounding boundary
CODE_MISMATCH_SHARE = 1e-2
#: the logits of a step once some code differs from the reference's
CODE_MISMATCH_TOL = 1e-2
B = 2
#: decode cases: id -> (arch, layers, config changes, cache_len, steps)
DECODE_CASES = {
    "dense-ring": ("smollm-135m", None, {}, 8, 12),
    "dense-window": ("smollm-135m", None, {"sliding_window": 6}, 8, 12),
    "moe-ring": ("granite-moe-3b-a800m", None, {}, 8, 12),
    "hybrid-ring": ("zamba2-7b", 5, {}, 8, 12),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return dict(convert._leaves(tree))


def models(arch, layers=None, seed=0, **changes):
    """The reference (jitted functions, params) and the port's model on the
    same parameters, for the reduced ``arch`` with ``kv_quant`` on."""
    changes = dict(changes, kv_quant=True)
    if layers:
        changes["num_layers"] = layers
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    jm = jax_build_model(jcfg)
    key = jax.random.PRNGKey(seed)
    params = compiled(jm.init, key)(key)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params(_np(params), cfg, "cpu"))
    return jm, params, cfg, model


def quant_rows():
    """[B, 1, KV, hd] = [4, 1, 64, 64] rows: random of many magnitudes;
    ties (max |x| = 127·2^k, so the scale is 2^k and (m + 1/2)·2^k divides
    to a tie); all-zero rows; and magnitudes near the f32 limits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1, 64, 64)).astype(np.float32)
    x *= np.float32(10.0) ** rng.uniform(-6, 6, (4, 1, 64, 1)).astype(np.float32)
    for h, k in enumerate(range(-3, 5)):
        m = rng.integers(-126, 126, 64).astype(np.float32) + np.float32(0.5)
        x[1, 0, h] = m * np.float32(2.0 ** k)
        x[1, 0, h, 0] = np.float32(127 * 2.0 ** k)
    x[2, 0, :4] = 0.0
    x[3, 0, 0] *= np.float32(1e-30)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    x = quant_rows()
    xj = jnp.asarray(x[:, 0]).astype(dtype)                     # [B, KV, hd]
    ref_q, ref_s = map(np.asarray, compiled(JaxLyr._quantize_kv, xj)(xj))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = Lyr.quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == xt.shape and s.shape == (4, 1, 64, 1)
    np.testing.assert_array_equal(s[:, 0].numpy(), ref_s)
    np.testing.assert_array_equal(q[:, 0].numpy(), ref_q)
    # the tie rows hold ties, rounded half to even; zero rows: scale 1e-8
    if dtype == "float32":
        codes = q[1, 0, :8, 1:].numpy().astype(np.float64)
        ties = x[1, 0, :8, 1:] / (np.float32(2.0) ** np.arange(-3, 5, dtype=np.float32)[:, None])
        np.testing.assert_array_equal(codes, np.round(ties))
        assert (np.abs(ties - np.trunc(ties)) == 0.5).all()
    assert (s[2, 0, :4] == np.float32(1e-8)).all() and (q[2, 0, :4] == 0).all()
    # the jitted reference's scale is the product by fl(1/127), which is not
    # the quotient on every row
    amax = np.abs(xt.float().numpy()).max(-1, keepdims=True)
    quotient = np.maximum(amax / np.float32(127.0), np.float32(1e-8))
    assert (quotient != s.numpy()).any()


def reference_decode(jm, params, caches, tokens, start=0):
    """The reference's teacher-forced decode of tokens [B, N] from
    ``caches`` at positions start.. : [(logits, caches)] after each step."""
    t0, p0 = jnp.asarray(tokens[:, :1]), jnp.zeros((B, 1), jnp.int32)
    dec = compiled(jm.decode_step, params, caches, t0, p0)
    out = []
    for i in range(tokens.shape[1]):
        pos = jnp.full((B, 1), start + i, jnp.int32)
        logits, caches = dec(params, caches, jnp.asarray(tokens[:, i:i + 1]), pos)
        out.append((np.asarray(logits), _np(caches)))
    return out


def assert_caches_close(port_tree, ref_tree, what, diverged=False) -> bool:
    """Every cache tensor of the reference: int8 codes within one step and
    equal in all but CODE_MISMATCH_SHARE of the entries, pos and idx
    equal, the rest (scales, SSM states) within TOL of the largest, or
    within CODE_MISMATCH_TOL once a code has differed (``diverged``, or a
    code differs now). Returns whether every code is equal."""
    port, want = _flat(port_tree), _flat(ref_tree)
    assert port.keys() == want.keys(), (what, sorted(port), sorted(want))
    codes_equal = True
    for path, a in want.items():
        got = port[path]
        assert got.dtype == convert.tensor(a, "cpu").dtype, (what, path)
        if a.dtype == np.int8:
            diff = np.abs(got.numpy().astype(np.int32) - a.astype(np.int32))
            assert diff.max() <= 1, (what, path, diff.max())
            assert (diff > 0).mean() <= CODE_MISMATCH_SHARE, (what, path, (diff > 0).mean())
            codes_equal &= not diff.any()
        elif path.endswith(("pos", "idx")):
            np.testing.assert_array_equal(got.numpy(), a, err_msg=f"{what} {path}")
    tol = TOL if codes_equal and not diverged else CODE_MISMATCH_TOL
    for path, a in want.items():
        if a.dtype.kind == "f":
            assert_close(port[path], a, tol, f"{what} {path}")
    return codes_equal


@torch.inference_mode()
def check_decode(model, caches, ref_steps, tokens, start=0, what=""):
    """The port's teacher-forced decode from ``caches`` against the
    reference's steps (``reference_decode``): after each step the caches
    (``assert_caches_close``) and the logits, within TOL until a code
    differs from the reference's, CODE_MISMATCH_TOL from then on (the
    difference flows on through the later layers and steps). Returns the
    caches and the number of steps before the first differing code."""
    agreed, diverged = 0, False
    for i, (ref_logits, ref_caches) in enumerate(ref_steps):
        pos = torch.full((B, 1), start + i, dtype=torch.int32)
        logits, caches = model.decode_step(caches, torch.from_numpy(tokens[:, i:i + 1]),
                                           pos)
        diverged |= not assert_caches_close(caches.tree, ref_caches,
                                            f"{what} step {i}", diverged)
        assert_close(logits, ref_logits, CODE_MISMATCH_TOL if diverged else TOL,
                     f"{what} step {i}")
        agreed += not diverged
    return caches, agreed


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_from_int8_caches_matches_reference(case):
    arch, layers, changes, C, N = DECODE_CASES[case]
    jm, params, cfg, model = models(arch, layers, **changes)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, N)).astype(np.int32)
    ref_caches = compiled(lambda: jm.init_caches(B, C))()
    caches = model.init_caches(B, C, device="cpu")
    # the int8 cache's layout, as the reference's
    assert_caches_close(caches.tree, _np(ref_caches), case)
    caches, agreed = check_decode(model, caches,
                                  reference_decode(jm, params, ref_caches, tokens),
                                  tokens, what=case)
    kv = caches.tree["shared_kv"] if cfg.family == "hybrid" else caches.tree
    assert kv["k"].dtype == torch.int8 and int(kv["idx"][0]) == N > C
    assert agreed >= 3, (case, agreed)


def test_decode_after_a_prefill_stays_unquantized():
    """With kv_quant, prefill writes model-dtype k/v (the reference's
    pad_kv), and the decode steps after it run the unquantized branch."""
    jm, params, cfg, model = models("smollm-135m")
    S, N = 16, 4
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, N)).astype(np.int32)
    t = jnp.asarray(prompt)
    ref_last, ref_caches = compiled(lambda p, t_: jm.prefill(p, t_, None, cache_len=S + N),
                                    params, t)(params, t)
    assert set(ref_caches) == {"k", "v", "pos", "idx"}
    with torch.inference_mode():
        last, caches = model.prefill(torch.from_numpy(prompt), cache_len=S + N)
    assert set(caches.tree) == {"k", "v", "pos", "idx"}
    assert caches.tree["k"].dtype == caches.tree["v"].dtype == torch.float32
    assert_close(last, ref_last, TOL, "prefill")
    # no int8 code is written: every step is held at TOL
    _, agreed = check_decode(model, caches,
                             reference_decode(jm, params, ref_caches, tokens, start=S),
                             tokens, start=S, what="after prefill")
    assert agreed == N


@pytest.mark.parametrize("arch,layers", [("smollm-135m", None), ("zamba2-7b", 5)])
def test_lm_caches_takes_int8_caches(arch, layers):
    """The reference's int8 caches after 6 steps, converted, decode 4 more
    steps as the reference's do."""
    jm, params, cfg, model = models(arch, layers)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 10)).astype(np.int32)
    mid = reference_decode(jm, params, compiled(lambda: jm.init_caches(B, 8))(),
                           tokens[:, :6])[-1][1]
    caches = convert.lm_caches(mid, cfg, "cpu")
    kv = caches.tree["shared_kv"] if cfg.family == "hybrid" else caches.tree
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
    for path, a in _flat(mid).items():
        np.testing.assert_array_equal(_flat(caches.tree)[path].numpy(), a)
    check_decode(model, caches,
                 reference_decode(jm, params, jax.tree.map(jnp.asarray, mid),
                                  tokens[:, 6:], start=6),
                 tokens[:, 6:], start=6, what=arch)


@pytest.mark.parametrize("arch,layers", [("smollm-135m", None), ("zamba2-7b", 5)])
def test_slot_server_matches_reference_server(arch, layers):
    """More requests than slots (slots reused and reset) on int8 caches:
    the port's server and the reference's give the same tokens."""
    jm, params, cfg, model = models(arch, layers, seed=2)
    P, N = 8, 5
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, P).astype(np.int32) for _ in range(5)]
    jreqs = [JaxRequest(i, p, N) for i, p in enumerate(prompts)]
    jsrv = JaxSlotServer(jm, params, batch_slots=2, cache_len=P + N + 1)
    jstats = jsrv.run(jreqs)
    reqs = [Request(i, p, N) for i, p in enumerate(prompts)]
    srv = SlotServer(model, batch_slots=2, cache_len=P + N + 1, device="cpu")
    stats = srv.run(reqs)
    kv = srv.caches.tree["shared_kv"] if cfg.family == "hybrid" else srv.caches.tree
    assert kv["k"].dtype == torch.int8 and "k_scale" in kv
    assert stats["steps"] == jstats["steps"] and stats["tokens"] == 5 * N
    for req, jreq in zip(reqs, jreqs):
        assert req.done and req.out == jreq.out, (req.rid, req.out, jreq.out)


def test_reset_slot_zeroes_the_scales():
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(), kv_quant=True)
    caches = build_model(cfg, device="cpu").init_caches(3, 4, device="cpu")
    for t in caches.tree.values():
        t.fill_(7)
    caches.reset_slot(1)
    for name, t in caches.tree.items():
        if name == "idx":
            assert (t == 7).all()
            continue
        assert (t[:, 1] == (-1 if name == "pos" else 0)).all(), name
        assert (t[:, 0] == 7).all() and (t[:, 2] == 7).all(), name
    assert {"k_scale", "v_scale"} <= set(caches.tree)
