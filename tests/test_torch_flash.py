"""The port's flash attention (its plain version, on the CPU) and the
attention layer against the JAX package's: the reference's oracle
(kernels/flash_attention/ref.py) in the model layout, its Pallas kernel in
interpret mode (kernels/flash_attention/ops.py, as tests/test_kernels.py
runs it on the CPU), rms_norm, rope, and ``layers.attention`` without a
cache (prefill) and with the KV ring buffer (decode), on converted
parameters.

Tolerance: f32, summation order only: 1e-5 of the largest magnitude of the
reference's result (the Pallas kernel's online softmax: 2e-5). One bf16
case: both sides round f32 values to bf16 (2^-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import layers as jax_layers
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers

TOL = 1e-5


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _qkv(seed, B, S, H, KV, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype) for shape in
                 ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _oracle_model_layout(q, k, v, window):
    """The reference oracle on [B*H, S, d] after repeating the kv heads."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))

    out = jax_attention_ref(bh(q), bh(k), bh(v), window=window)
    return np.asarray(out, np.float32).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


CASES = [  # B, S, H, KV, hd, window
    (2, 64, 4, 2, 64, 0),       # reduced GQA
    (1, 200, 2, 2, 48, 0),      # ragged S, hd = 48
    (2, 96, 4, 1, 32, 40),      # MQA with a window
    (1, 130, 4, 2, 48, 64),     # GQA, window, ragged S, hd = 48
]


@pytest.mark.parametrize("case", CASES)
def test_plain_flash_matches_reference_oracle(case):
    *shape, window = case
    q, k, v = _qkv(sum(case), *shape)
    n0 = _build.LAUNCHES["flash_attention"]
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert _build.LAUNCHES["flash_attention"] == n0   # CPU: the plain version
    assert_close(out, _oracle_model_layout(q, k, v, window))


@pytest.mark.parametrize("case", CASES[1:])
def test_plain_flash_matches_interpret_mode_pallas(case):
    """The reference's Pallas kernel pads S to its block and repeats the kv
    heads; the port's plain version does neither."""
    *shape, window = case
    q, k, v = _qkv(3 + sum(case), *shape)
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                    interpret=True)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert_close(out, ref, 2 * TOL)


def test_plain_flash_bf16_output():
    q, k, v = _qkv(5, 1, 70, 4, 2, 64)
    out = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    qb, kb, vb = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
    assert_close(out.float(), _oracle_model_layout(qb, kb, vb, 0), 2 ** -7)


@pytest.mark.parametrize("window", [0, 24])
def test_split_bf16_p_keeps_the_f32_contract(window):
    """The bf16 tensor-core kernel's p v, emulated in torch: p = exp(s - max)
    in f32, split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both
    multiplied by the same bf16 V and summed in f32, then divided by the f32
    row sum. Before the output's bf16 rounding it is within 2^-15 of the
    largest |out| of the JAX reference's f32 attention_ref on the same bf16
    q, k, v (the split keeps 16 bits of p). One bf16 pass of p (p_hi only)
    is not: it is the contract the split guards."""
    rng = np.random.default_rng(14 + window)
    BH, S, d = 4, 96, 64
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((BH, S, d)).astype(np.float32),
                                      jnp.bfloat16), np.float32) for _ in range(3))
    ref = np.asarray(jax_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                       window=window), np.float64)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qt, kt) / d ** 0.5
    i = torch.arange(S)
    visible = i[None, :] <= i[:, None]
    if window:
        visible &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    row_sum = p.sum(-1, keepdim=True)
    p_hi = p.bfloat16()
    p_lo = (p - p_hi.float()).bfloat16()
    v_bf16 = vt.bfloat16().float()           # exact: v is bf16 already
    split = (p_hi.float() @ v_bf16 + p_lo.float() @ v_bf16) / row_sum
    single = (p_hi.float() @ v_bf16) / row_sum
    tol = 2.0 ** -15 * np.abs(ref).max()
    assert np.abs(split.double().numpy() - ref).max() <= tol
    assert np.abs(single.double().numpy() - ref).max() > tol


def test_flash_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 4, 3, 16))
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="expected shape"):
        flash_attention(q, k[:, :4], v)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    assert_close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
                 jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    assert_close(layers.rope_freqs(64, 10_000.0), jax_layers.rope_freqs(64, 10_000.0))
    # angles up to 5000 rad: f32 sin/cos of large arguments differ by an ulp
    # of the angle between libraries, so this one is held to 1e-4
    assert_close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
                 jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
                 1e-4)


@pytest.fixture(scope="module", params=["smollm-135m", "qwen3-4b"])
def attn(request):
    """One attention layer of a reduced dense config (smollm: GQA 4/2;
    qwen3: qk-norm), its parameters drawn by the reference and converted."""
    jcfg = jax_get_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    p_np = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_layers.attn_init(key, jcfg, jnp.float32))(jax.random.PRNGKey(1)))
    if cfg.qk_norm:
        rng = np.random.default_rng(1)
        for name in ("q_norm", "k_norm"):
            p_np[name] = (1 + 0.1 * rng.standard_normal(p_np[name].shape)).astype(np.float32)
    port = layers.Params({k: convert.tensor(v, "cpu") for k, v in p_np.items()})
    fwd = jax.jit(lambda p, x, pos, cache: jax_layers.attention(
        p, x, jcfg, jax_layers.Sharder(), pos, cache=cache, window=jcfg.sliding_window))
    return jcfg, cfg, jax.tree.map(jnp.asarray, p_np), port, fwd


def test_attention_without_cache_matches_reference(attn):
    jcfg, cfg, p_j, p_t, fwd = attn
    B, S = 2, 48
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out_r, _ = fwd(p_j, jnp.asarray(x), jnp.asarray(pos), None)
    out, k, v = layers.attention(p_t, torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()))
    assert_close(out, out_r)
    assert k.shape == v.shape == (B, S, cfg.eff_kv_heads, cfg.resolved_head_dim)


def test_attention_with_cache_matches_reference(attn):
    """Decode steps into a ring buffer shorter than the steps (it wraps),
    with never-written slots, positions that differ by batch row, and a
    slot reset in between."""
    jcfg, cfg, p_j, p_t, fwd = attn
    B, C = 3, 5
    cache_t = {k: v[0] for k, v in layers.init_kv_cache(
        cfg, 1, B, C, torch.float32, "cpu").items()}
    cache_j = jax_layers.init_kv_cache(jcfg, B, C, jnp.float32)
    rng = np.random.default_rng(3)
    pos = np.array([[0], [4], [9]], np.int32)
    for step in range(7):
        if step == 3:      # reset row 1: zeros, pos -1 (SlotServer._reset_slot)
            cache_j = {k: (v.at[1].set(-1 if k == "pos" else 0) if k != "idx" else v)
                       for k, v in cache_j.items()}
            for k in ("k", "v"):
                cache_t[k][1] = 0
            cache_t["pos"][1] = -1
            pos[1] = 0
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        out_r, cache_j = fwd(p_j, jnp.asarray(x), jnp.asarray(pos), cache_j)
        out, _, _ = layers.attention(p_t, torch.from_numpy(x), cfg,
                                     torch.from_numpy(pos.copy()), cache=cache_t)
        assert_close(out, out_r)
        for k in ("k", "v", "pos", "idx"):
            assert_close(cache_t[k], cache_j[k])
        pos += 1
