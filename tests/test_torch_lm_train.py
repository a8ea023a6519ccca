"""Federated training of the LM (core/lm.py, the decoder's training
``loss``) against the JAX package's, on the CPU at the reduced sizes, in
f32, from the reference's parameters (converted with
``convert.lm_flat_params``).

* ``loss`` and its flat gradient on the dense (reduced smollm-135m), ssm
  (mamba2-2.7b) and hybrid (the 5-layer zamba2-7b of test_torch_lm.py)
  configs at B=2, S=128, and the dense one at S=1024 (the reference's
  blocked attention), with a document mask: loss within rel 1e-5, the
  gradient within 1e-4 of the reference's largest magnitude; the flat
  vector converts back to the reference's tree bit for bit.
* ``make_lm_clients`` equals the reference's (token ids kept int).
* The reference's ``test_fl_lm_round_decreases_loss`` setup (reduced
  smollm, K=2, make_lm_tokens(8, 64), eta 0.3, L=3): every iterate of one
  round's SVRG trajectory within 1e-4 of its magnitude; the round's params
  within 1e-4·‖Δw‖ (FedSVRG) and 1e-3·‖Δw‖ (FedOSAA-SVRG, whose AA solve
  amplifies the f32 rounding by the Gram's conditioning); three rounds'
  losses within rel 1e-3, falling, and launch/fl_train.py's the same; the
  int8 wire fed the reference's uniforms.
* Every algorithm runs one round on the LM (port only).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.comm import make_channel as jax_make_channel
from repro.configs import get_arch as jax_get_arch
from repro.core import AlgoHParams as JaxHParams
from repro.core import algorithms as jax_algos
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.core.lm import make_lm_clients as jax_make_lm_clients
from repro.core.lm import make_lm_problem as jax_make_lm_problem
from repro.data import make_lm_tokens as jax_make_lm_tokens
from repro.models.decoder import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core import (ALGORITHMS, UPLINK_SCHEMAS, AlgoHParams,
                              ClientBatch, StackedClients, convert,
                              init_state, make_round_fn, run_federated)
from repro_torch.core.algorithms import _trajectory
from repro_torch.core.lm import (make_lm_clients, make_lm_problem,
                                 param_layout, unflatten)
from repro_torch.data import make_lm_tokens
from repro_torch.kernels import _build
from repro_torch.launch import fl_train
from repro_torch.models.decoder import build_model, functional_loss

from jax_compile import compiled
from torch_threads import one_torch_thread  # noqa: F401

B = 2
#: test id → (arch, layers, S)
CONFIGS = {"dense": ("smollm-135m", None, 128),
           "ssm": ("mamba2-2.7b", None, 128),
           "hybrid": ("zamba2-7b", 5, 128),
           "dense-blocked": ("smollm-135m", None, 1024)}
K, N_DOCS, SEQ, ETA, L = 2, 8, 64, 0.3, 3


def _configs(arch, layers):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return jcfg, cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(port, ref, tol, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradient_match_reference(name):
    check_loss_and_gradient(name, *CONFIGS[name])


def check_loss_and_gradient(name, arch, layers, S, changes=None):
    """The port's loss within rel 1e-5 and its flat gradient within 1e-4 of
    the reference's largest magnitude, at B=2 with a document mask (and a
    vlm/audio config's frontend embeddings, whose positions carry no loss);
    the flat vector converts back to the reference's tree bit for bit.
    ``changes``: a function applied to both configs (``padded``)."""
    jcfg, cfg = _configs(arch, layers)
    if changes is not None:
        jcfg, cfg = changes(jcfg), changes(cfg)
    jm = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = compiled(jm.init, key)(key)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    batch = {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)}
    pbatch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
    if cfg.frontend_tokens:
        embeds = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                     ).astype(np.float32)
        batch["embeds"], pbatch["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    ref_loss, ref_grad = compiled(jax.value_and_grad(jm.loss), params, batch)(params, batch)

    model = build_model(cfg, device="cpu")
    w = convert.lm_flat_params(_np(params), model, "cpu")
    assert w.shape == (sum(p.numel() for p in model.parameters()),)
    back = convert.lm_unflat_params(w, model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    layout = param_layout(model)
    loss_fn = functional_loss(model)
    n0 = dict(_build.LAUNCHES)

    def flat_loss(v):
        return loss_fn(unflatten(v, layout), pbatch)

    loss = flat_loss(w)
    g = grad(flat_loss)(w)
    assert _build.LAUNCHES == n0
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert_close(g, convert.lm_flat_params(_np(ref_grad), model, "cpu"), 1e-4, name)


def test_lm_clients_match_reference():
    toks = jax_make_lm_tokens(10, 16, 1000)
    np.testing.assert_array_equal(make_lm_tokens(10, 16, 1000), toks)
    want = jax_make_lm_clients(toks, 3)
    got = make_lm_clients(toks, 3, device="cpu")
    assert got.x.dtype == torch.int32
    for f in ("x", "y", "mask", "weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_stacked_clients_to_keeps_integer_features():
    c = StackedClients(torch.ones((2, 3, 4), dtype=torch.int32),
                       torch.ones((2, 3), dtype=torch.int32),
                       torch.ones((2, 3)), torch.full((2,), 0.5))
    out = c.to("cpu", torch.float64)
    assert out.x.dtype == torch.int32
    assert out.y.dtype == out.mask.dtype == torch.float64
    assert out.weight.dtype == torch.float32
    floats = StackedClients(c.x.float(), c.y, c.mask, c.weight).to("cpu", torch.float64)
    assert floats.x.dtype == torch.float64


def test_unsupported_configs_raise():
    cfg = get_arch("smollm-135m").reduced()
    model = build_model(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    clients = make_lm_clients(make_lm_tokens(4, 8, cfg.vocab_size), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="the JAX reference cannot train "
                                                  "one either"):
        make_lm_problem(model, clients)
    from repro_torch.core.lm import check_fl_config
    moe = get_arch("granite-moe-3b-a800m").reduced()
    check_fl_config(moe)                            # f32: one dtype
    with pytest.raises(NotImplementedError, match="mixed-dtype flat state"):
        check_fl_config(dataclasses.replace(moe, dtype="float64"))


def test_gram_design_follows_the_shape():
    """The split Gram design serves few clients of a wide d (m <= 8); the
    shapes of the earlier slices keep the one-block design."""
    from repro_torch.kernels.anderson.ops import gram_parts
    assert gram_parts(100, 10, 54, 132) == 0              # the paper-scale round
    assert gram_parts(16, 10, 1 << 20, 132) == 0          # m > 8
    assert gram_parts(4, 3, 1 << 15, 132) == 0            # a narrow d
    assert gram_parts(132, 3, 1 << 24, 132) == 0          # a client an SM
    assert gram_parts(4, 3, 162_826_560, 132) == 264      # smollm-135m, K=4
    assert gram_parts(2, 8, 100_003, 132) == 13           # parts >= 8192 wide


# --------------------------------------------------------------------------
# rounds: the reference's test_fl_lm_round_decreases_loss setup
# --------------------------------------------------------------------------

def fl_setup(arch):
    """Both problems on the same tokens, the reference's starting params
    (its run_federated's init, key 0) and, per algorithm, its first three
    rounds (states and metrics) from them."""
    jcfg, cfg = _configs(arch, None)
    toks = jax_make_lm_tokens(N_DOCS, SEQ, jcfg.vocab_size)
    jp = jax_make_lm_problem(jax_build_model(jcfg), jax_make_lm_clients(toks, K))
    model = build_model(cfg, device="cpu")
    pp = make_lm_problem(model, make_lm_clients(toks, K, device="cpu"))
    jhp = JaxHParams(eta=ETA, local_epochs=L, aa_impl="tree", local_impl="tree")
    rounds = {}
    # on the identity wire both algorithms start from the same state
    key = jax.random.PRNGKey(0)
    state = compiled(lambda k: jax_init_state(jp, k, jhp, None, "fedsvrg"), key)(key)
    for algo in ("fedsvrg", "fedosaa_svrg"):
        rf = compiled(jax_make_round_fn(algo, jp, jhp), state)
        rows = [(state, None)]
        for _ in range(3):
            rows.append(rf(rows[-1][0]))
        rounds[algo] = rows
    w0_tree = _np(rounds["fedsvrg"][0][0].params)
    w0 = convert.lm_flat_params(w0_tree, model, "cpu")
    return dict(arch=arch, jp=jp, pp=pp, model=model, jhp=jhp, rounds=rounds,
                w0=w0, w0_tree=w0_tree)


@pytest.fixture(scope="module")
def fl():
    return fl_setup("smollm-135m")


def _flat(fl, tree):
    return convert.lm_flat_params(_np(tree), fl["model"], "cpu")


def test_svrg_trajectory_matches_reference(fl):
    jp, pp, jhp = fl["jp"], fl["pp"], fl["jhp"]
    def reference(w_t):
        g = jp.global_grad(w_t)
        return g, jax.vmap(lambda x, y, m: jax_algos._svrg_trajectory(
            jp, jhp, w_t, g, jax_algos.ClientBatch(x, y, m), jax.random.PRNGKey(0)))(
            jp.clients.x, jp.clients.y, jp.clients.mask)

    w_t = fl["rounds"]["fedsvrg"][0][0].params
    g_ref, (ref_w, ref_r) = compiled(reference, w_t)(w_t)
    g = pp.global_grad(fl["w0"])
    assert_close(g, _flat(fl, g_ref), 1e-4, "global gradient")
    c = pp.clients
    w_traj, r_traj = _trajectory(pp, AlgoHParams(eta=ETA, local_epochs=L), fl["w0"],
                                 ClientBatch(c.x, c.y, c.mask), None, 1.0, g)
    assert w_traj.shape == r_traj.shape == (K, L + 1, fl["w0"].numel())
    for k in range(K):
        for step in range(L + 1):
            pick = jax.tree.map(lambda a: a[k, step], (ref_w, ref_r))
            assert_close(w_traj[k, step], _flat(fl, pick[0]), 1e-4, f"w[{k}, {step}]")
            assert_close(r_traj[k, step], _flat(fl, pick[1]), 1e-4, f"r[{k}, {step}]")


@pytest.mark.parametrize("algo,tol", [("fedsvrg", 1e-4), ("fedosaa_svrg", 1e-3)])
def test_one_round_matches_reference(fl, algo, tol):
    ref_state, ref_m = fl["rounds"][algo][1]
    rf = make_round_fn(algo, fl["pp"], AlgoHParams(eta=ETA, local_epochs=L), device="cpu")
    state = init_state(fl["pp"], device="cpu", algo=algo)._replace(params=fl["w0"])
    new, m = rf(state)
    want = _flat(fl, ref_state.params)
    step = float(torch.linalg.vector_norm(want - fl["w0"]))
    err = float((new.params - want).abs().max())
    print(f"{algo}: max |w - w_ref| {err:.3e}, ‖Δw‖ {step:.3e}, gram cond "
          f"{float(m.gram_cond_max):.3e} (reference {float(ref_m.gram_cond_max):.3e})")
    assert err <= tol * step
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-5)


def test_fl_train_tracks_reference(fl, tmp_path, monkeypatch):
    """launch/fl_train.py on the same setup (the reference fl_train's
    arguments for it), its model loaded with the reference's initial
    params: its loss curve within rel 1e-3 of the reference's rounds
    (fl_train's AA takes Tikhonov 1e-8, the fixture's rounds 1e-10)."""
    build = fl_train.build_model

    def with_reference_init(cfg, device, seed=0):
        model = build(cfg, device=device, seed=seed)
        model.load_state_dict(convert.lm_params(fl["w0_tree"], cfg, device))
        return model

    monkeypatch.setattr(fl_train, "build_model", with_reference_init)
    out = tmp_path / "fl_train.json"
    res = fl_train.main(["--device", "cpu", "--arch", fl["arch"], "--reduced",
                         "--clients", str(K), "--docs-per-client", str(N_DOCS // K),
                         "--seq-len", str(SEQ), "--local-epochs", str(L), "--eta",
                         str(ETA), "--rounds", "3", "--out", str(out)])
    want = [float(m.loss) for _, m in fl["rounds"]["fedosaa_svrg"][1:]]
    np.testing.assert_allclose(res["fedosaa_svrg"]["loss_curve"], want, rtol=1e-3)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))


@pytest.mark.parametrize("algo", ["fedsvrg", "fedosaa_svrg"])
def test_three_rounds_track_reference(fl, algo):
    h = run_federated(fl["pp"], algo, AlgoHParams(eta=ETA, local_epochs=L), 3,
                      w0=fl["w0"], device="cpu")
    want = [float(m.loss) for _, m in fl["rounds"][algo][1:]]
    np.testing.assert_allclose(h.loss, want, rtol=1e-3)
    assert np.isfinite(h.loss).all() and h.loss[-1] < h.loss[0]


def _reference_int8_draws(fl, state, algo):
    """The reference's int8 uniforms of each uplink of the round from
    ``state``, laid out on the port's flat vector: each reference leaf
    (jax flatten order) draws its own [chunks, 256] grid
    (repro/comm/codecs.py::tree_roundtrip), and every per-layer segment of
    the reduced config is a whole number of 256-value chunks, so port chunk
    j is one chunk of one leaf."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(fl["w0_tree"])[0]]
    leaf_index = {p: i for i, p in enumerate(paths)}
    sizes = {p: int(np.prod(a.shape)) for p, a in
             zip(paths, jax.tree.leaves(fl["w0_tree"]))}
    segments = []          # (leaf index, first chunk, chunks) in port order
    for name, shape in param_layout(fl["model"]):
        parts = name.split(".")
        n = int(np.prod(shape))
        assert n % 256 == 0, name
        if parts[0] in ("blocks", "mamba_groups", "mamba_tail"):
            key = "".join(f"['{p}']" for p in [parts[0]] + parts[2:])
            off = int(parts[1]) * n
        else:
            key, off = "".join(f"['{p}']" for p in parts), 0
        assert sizes[key] % 256 == 0
        segments.append((leaf_index[key], off // 256, n // 256))
    keys = jax.random.split(jax.random.split(state.rng, 3)[2], K)
    draws = {}
    for spec in UPLINK_SCHEMAS[algo]:
        rows = []
        for k in range(K):
            grids = {i: np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(keys[k], spec.fold), i),
                (sizes[paths[i]] // 256, 256), jnp.float32)) for i in range(len(paths))}
            rows.append(np.concatenate([grids[i][c0:c0 + n] for i, c0, n in segments]))
        draws[spec.tag] = torch.from_numpy(np.stack(rows))
    return draws


def test_int8_round_matches_reference(fl):
    algo = "fedosaa_svrg"
    jp, jhp = fl["jp"], fl["jhp"]
    state = fl["rounds"][algo][0][0]
    state = state._replace(comm=jax_algos.init_comm_state(
        jax_make_channel("int8"), state.params, K, algo))
    ref_new, ref_m = compiled(jax_make_round_fn(algo, jp, jhp, "int8"), state)(state)
    rf = make_round_fn(algo, fl["pp"], AlgoHParams(eta=ETA, local_epochs=L),
                       channel="int8", device="cpu")
    start = init_state(fl["pp"], device="cpu", channel="int8", algo=algo)
    new, m = rf(start._replace(params=fl["w0"]), _reference_int8_draws(fl, state, algo))
    want = _flat(fl, ref_new.params)
    step = float(torch.linalg.vector_norm(want - fl["w0"]))
    err = float(torch.linalg.vector_norm(new.params - want))
    print(f"int8: ‖w - w_ref‖ {err:.3e}, ‖Δw‖ {step:.3e}")
    # a value within an ulp of an int8 rounding boundary may round the
    # other way: the params are held in norm
    assert err <= 1e-3 * step
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-5)
    assert float(m.comm_bytes) == float(ref_m.comm_bytes)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_algorithm_runs_a_round_on_the_lm(fl, algo):
    pp = fl["pp"]
    # one CG iteration a DANE Newton step: on the LM's indefinite Hessian a
    # second one overflows (p·Hp < 0 is clamped to 1e-30), in the
    # reference's DANE as in the port's
    hp = AlgoHParams(eta=0.1, local_epochs=1, dane_newton_iters=1, dane_cg_iters=1)
    state = init_state(pp, device="cpu", algo=algo, hp=hp)._replace(params=fl["w0"])
    new, m = make_round_fn(algo, pp, hp, device="cpu")(state)
    assert new.params.shape == fl["w0"].shape and new.t == 1
    assert torch.isfinite(new.params).all() and np.isfinite(float(m.loss))
    if algo in ("scaffold", "fedosaa_scaffold"):
        assert new.c.shape == fl["w0"].shape and new.c_k.shape == (K, fl["w0"].numel())
