"""optim/ and launch/steps.py's training steps against the JAX package's,
on the CPU: 20 updates of sgd (plain, momentum, nesterov) and adamw (with
weight decay, on a schedule), each on clipped gradients
(clip_by_global_norm), within rel 1e-6 of the reference's on the same
gradient sequence; the schedules at every step 0..N within rel 1e-6 (f32
on both sides, the order of the operations kept); make_train_step on the
reduced smollm and make_aa_step against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import make_aa_step as jax_make_aa_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.decoder import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.launch.steps import make_aa_step, make_train_step
from repro_torch.models.decoder import build_model

from jax_compile import compiled
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
STEPS, N = 20, 100


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * (1 + 2 * i)).astype(np.float32)
             for k, s in SHAPES.items()} for i in range(STEPS)]


def _run(opt, params, grads, clip, torch_side):
    state = opt.init(params)
    for g in grads:
        if torch_side:
            g = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, clip)
        else:
            g = jax_optim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, clip)
        params, state = opt.update(g, state, params)
    return params, state


OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
    "nesterov": lambda m, lr: m.sgd(lr, momentum=0.9, nesterov=True),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.01),
    "adamw-wsd": lambda m, lr: m.adamw(m.wsd(lr, STEPS), weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _grads()
    ref, ref_state = _run(OPTIMIZERS[name](jax_optim, 0.05),
                          {k: jnp.asarray(v) for k, v in p0.items()}, grads, 3.0, False)
    got, state = _run(OPTIMIZERS[name](optim, 0.05),
                      {k: torch.from_numpy(v) for k, v in p0.items()}, grads, 3.0, True)
    assert int(state.step) == int(ref_state.step) == STEPS
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_clip_by_global_norm_matches_reference():
    g = _grads(2)[5]
    for clip in (0.5, 1e6):
        want = jax_optim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, clip)
        got = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, clip)
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedule_matches_reference(name):
    make = {"constant": lambda m: m.constant(3e-3),
            "cosine": lambda m: m.cosine(3e-3, N, warmup=N // 20),
            "wsd": lambda m: m.wsd(3e-3, N)}[name]
    ref, port = make(jax_optim), make(optim)
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in range(N + 1)], np.float32)
    got = np.array([float(port(torch.tensor(s, dtype=torch.int32))) for s in range(N + 1)],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert port(torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


def test_train_step_matches_reference():
    jcfg, cfg = jax_get_arch("smollm-135m").reduced(), get_arch("smollm-135m").reduced()
    jm = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = compiled(jm.init, key)(key)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    corr = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 1e-3), params)
    args = (params, {"tokens": jnp.asarray(tokens)}, corr)
    new, r, loss = compiled(jax_make_train_step(jm, eta=0.1), *args)(*args)
    model = build_model(cfg, device="cpu")

    def port(tree):
        return convert.lm_params(jax.tree.map(np.asarray, tree), cfg, "cpu")

    p_new, p_r, p_loss = make_train_step(model, eta=0.1)(
        port(params), {"tokens": torch.from_numpy(tokens)}, port(corr))
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-5)
    for got, want in ((p_new, port(new)), (p_r, port(r))):
        assert got.keys() == want.keys()
        for k in want:
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-4 * float(want[k].abs().max()) + 1e-7, k


def test_aa_step_matches_reference():
    rng = np.random.default_rng(4)
    m = 3

    def tree(*lead):
        return {"a": rng.standard_normal(lead + (6,)).astype(np.float32),
                "b": rng.standard_normal(lead + (2, 3)).astype(np.float32)}

    w, g, s, y = tree(), tree(), tree(m), tree(m)
    new, theta = jax_make_aa_step(eta=0.1)(*(jax.tree.map(jnp.asarray, t) for t in (w, g, s, y)))

    def flat(t, lead=()):
        return torch.from_numpy(np.concatenate([t[k].reshape(lead + (-1,)) for k in ("a", "b")],
                                               axis=-1))

    p_new, p_theta = make_aa_step(eta=0.1)(flat(w), flat(g), flat(s, (m,)), flat(y, (m,)))
    want = flat(jax.tree.map(np.asarray, new))
    assert float((p_new - want).abs().max()) <= 1e-5 * float(want.abs().max())
    np.testing.assert_allclose(float(p_theta), float(theta), rtol=1e-5)
