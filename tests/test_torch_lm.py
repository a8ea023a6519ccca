"""The port's LM serving path against the JAX package's, on the CPU at the
reduced sizes, in f32, from one set of parameters (the reference's init,
converted with ``convert.lm_params``): ``forward``, ``prefill`` (last
logits and every cache tensor), 4 ``decode_step``s from the reference's
prefill caches (converted with ``convert.lm_caches``), and the slot server.

Configs: one per served family (smollm-135m dense, mamba2-2.7b ssm,
zamba2-7b hybrid) and a 5-layer Zamba2 variant whose ``hybrid_counts`` is
(2, 1, 1), so the trailing Mamba-2 layers run. S = 128 crosses the reduced
configs' SSD chunk of 64.

Tolerance: 1e-4 of the largest magnitude of the reference's tensor, for
logits and caches alike (f32; summation order, the plain flash attention
in place of the reference's materialized softmax, and the SSD recurrence
taken in order where the reference scans associatively). The slot server's
greedy tokens must be equal.
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
from repro.models.decoder import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.decoder import build_model

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
B, S, N_DECODE = 2, 128, 4
CONFIGS = {"smollm-135m": ("smollm-135m", None),
           "mamba2-2.7b": ("mamba2-2.7b", None),
           "zamba2-7b": ("zamba2-7b", None),
           "zamba2-7b-5-layers": ("zamba2-7b", 5)}


def assert_close(port, ref, tol=TOL, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def _configs(name):
    arch, layers = CONFIGS[name]
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return jcfg, cfg


@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request):
    """Both models on one set of parameters, and the reference's results:
    forward logits, prefill (last logits, caches) and 4 greedy decode steps
    from those caches. Each JAX function is jitted once here."""
    jcfg, cfg = _configs(request.param)
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                            "cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = {"forward": np.asarray(jax.jit(jm.forward)(params, jnp.asarray(tokens))[0])}
    last, caches = jax.jit(lambda p, t: jm.prefill(p, t, None, cache_len=S + 8))(
        params, jnp.asarray(tokens))
    ref["prefill"] = (np.asarray(last), jax.tree.map(np.asarray, caches))
    dec = jax.jit(jm.decode_step)
    steps, tok = [], np.argmax(ref["prefill"][0], -1)[:, None].astype(np.int32)
    for i in range(N_DECODE):
        pos = np.full((B, 1), S + i, np.int32)
        logits, caches = dec(params, caches, jnp.asarray(tok), jnp.asarray(pos))
        steps.append((tok, pos, np.asarray(logits)))
        tok = np.argmax(np.asarray(logits), -1)[:, None].astype(np.int32)
    ref["decode"] = (steps, jax.tree.map(np.asarray, caches))
    return request.param, cfg, model, tokens, ref


def _flat(tree):
    return dict(convert._leaves(tree))


@torch.inference_mode()
def test_forward_matches_reference(lm):
    name, cfg, model, tokens, ref = lm
    logits, aux = model(torch.from_numpy(tokens))
    assert logits.shape == (B, S, cfg.eff_vocab) and float(aux) == 0.0
    assert_close(logits, ref["forward"], what=name)


@torch.inference_mode()
def test_prefill_matches_reference(lm):
    """Last-position logits and every cache tensor (k, v, pos, idx; conv,
    ssm), through the prefill step."""
    name, cfg, model, tokens, ref = lm
    n0 = dict(_build.LAUNCHES)
    last, caches = make_prefill_step(model, S + 8)(torch.from_numpy(tokens))
    assert _build.LAUNCHES == n0            # CPU: the plain versions
    ref_last, ref_caches = ref["prefill"]
    assert_close(last, ref_last, what=name)
    port, want = _flat(caches.tree), _flat(ref_caches)
    assert port.keys() == want.keys()
    for path, a in want.items():
        assert port[path].dtype == convert.tensor(a, "cpu").dtype, path
        assert_close(port[path], a, what=f"{name} {path}")


@torch.inference_mode()
def test_decode_steps_match_reference(lm):
    """4 decode steps from the reference's prefill caches, converted:
    logits each step, every cache tensor after the last."""
    name, cfg, model, tokens, ref = lm
    caches = convert.lm_caches(ref["prefill"][1], cfg, "cpu")
    serve_step = make_serve_step(model)
    steps, ref_caches = ref["decode"]
    for i, (tok, pos, ref_logits) in enumerate(steps):
        logits, caches = serve_step(caches, torch.from_numpy(tok), torch.from_numpy(pos))
        assert_close(logits, ref_logits, what=f"{name} step {i}")
    port, want = _flat(caches.tree), _flat(ref_caches)
    assert port.keys() == want.keys()
    for path, a in want.items():
        assert_close(port[path], a, what=f"{name} {path}")


def _prompts(cfg, n, P, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, P).astype(np.int32) for _ in range(n)]


@torch.inference_mode()
def _single_request(model, prompt, n_new):
    """Greedy decode of one request through prefill + decode_step."""
    last, caches = model.prefill(torch.from_numpy(prompt)[None],
                                 cache_len=len(prompt) + n_new + 1)
    tok = last.argmax(-1, keepdim=True).to(torch.int32)
    out = [int(tok[0, 0])]
    for i in range(n_new - 1):
        pos = torch.full((1, 1), len(prompt) + i, dtype=torch.int32)
        logits, caches = model.decode_step(caches, tok, pos)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(int(tok[0, 0]))
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_slot_server_matches_single_request_decode(arch):
    """Batched slot serving gives each request the tokens of its own
    prefill + decode (as tests/test_serve.py holds the reference)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu", seed=1)
    P, N = 12, 6
    prompts = _prompts(cfg, 3, P, 0)
    refs = [_single_request(model, p, N) for p in prompts]
    reqs = [Request(i, p, N) for i, p in enumerate(prompts)]
    SlotServer(model, batch_slots=4, cache_len=P + N + 2, device="cpu").run(reqs)
    for req, want in zip(reqs, refs):
        assert req.out == want, (req.rid, req.out, want)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_slot_server_matches_reference_server(arch):
    """More requests than slots (slots are reused and reset): the port's
    server and the reference's give the same tokens on the same weights."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                            "cpu"))
    P, N = 8, 5
    prompts = _prompts(cfg, 5, P, 3)
    jreqs = [JaxRequest(i, p, N) for i, p in enumerate(prompts)]
    jstats = JaxSlotServer(jm, params, batch_slots=2, cache_len=P + N + 1).run(jreqs)
    reqs = [Request(i, p, N) for i, p in enumerate(prompts)]
    stats = SlotServer(model, batch_slots=2, cache_len=P + N + 1, device="cpu").run(reqs)
    assert stats["steps"] == jstats["steps"] and stats["tokens"] == 5 * N
    for req, jreq in zip(reqs, jreqs):
        assert req.done and req.out == jreq.out, (req.rid, req.out, jreq.out)


def test_caches_reset_slot():
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), num_layers=5)
    model = build_model(cfg, device="cpu")
    caches = model.init_caches(3, 4, device="cpu")
    for g in caches.groups():
        for t in g.values():
            t.fill_(7)
    caches.reset_slot(1)
    tree = caches.tree
    assert set(tree) == {"mamba", "shared_kv", "tail"}
    for g in caches.groups():
        for name, t in g.items():
            if name == "idx":
                assert (t == 7).all()
                continue
            assert (t[:, 1] == (-1 if name == "pos" else 0)).all(), name
            assert (t[:, 0] == 7).all() and (t[:, 2] == 7).all(), name


def test_entry_points_default_to_the_card(capsys):
    """build_model, init_caches, SlotServer and serve.main default to the
    card: without one they raise, unless given device="cpu"."""
    cfg = get_arch("zamba2-7b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_caches(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotServer(model, batch_slots=2, cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-7b", "--requests", "1"])
    serve.main(["--arch", "zamba2-7b", "--requests", "3", "--slots", "2",
                "--new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_unserved_parts_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        build_model(get_arch("granite-moe-3b-a800m").reduced(), device="cpu")
    model = build_model(get_arch("smollm-135m").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="frontend"):
        model(torch.zeros(1, 4, dtype=torch.int32), embeds=torch.zeros(1, 2, 256))
    with pytest.raises(ValueError, match="shorter than the prompt"):
        model.prefill(torch.zeros(1, 8, dtype=torch.int32), cache_len=4)


def test_convert_checks_cache_groups_and_keeps_bfloat16():
    """lm_caches refuses caches of another family's layout; bf16 arrays
    (ml_dtypes, as np.asarray gives them) convert bit for bit."""
    cfg = get_arch("zamba2-7b").reduced()
    jm = jax_build_model(jax_get_arch("zamba2-7b").reduced())
    caches = jax.tree.map(np.asarray, jm.init_caches(2, 8))
    assert set(convert.lm_caches(caches, cfg, "cpu").tree) == {"mamba", "shared_kv"}
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_caches(caches["mamba"], cfg, "cpu")
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = convert._array_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), torch.from_numpy(a.astype(np.float32)))
