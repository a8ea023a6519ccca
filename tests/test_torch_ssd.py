"""The port's SSD step (its plain version, on the CPU) against the JAX
package's: the reference's oracle (kernels/ssd/ref.py), its Pallas kernel
in interpret mode (kernels/ssd/ops.py, as tests/test_kernels.py runs it
on the CPU), the chunked scan and the Mamba-2 mixer, chunked and
recurrent, on parameters converted from the reference's.

Tolerance: f32 throughout; the two sides differ in summation order only,
so 1e-5 of the largest magnitude of the reference's result (2e-5 for the
mixer, whose output passes through more sums)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.ssd.ops import ssd_chunk as jax_ssd_pallas
from repro.kernels.ssd.ref import ssd_chunk_ref as jax_ssd_ref
from repro.models import layers as jax_layers
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_ref
from repro_torch.models import layers

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _case(seed, B, nc, Q, nh, hd, st):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32)
    dtc = rng.uniform(0.01, 0.3, (B, nc, Q, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (nh,)).astype(np.float32)
    da = np.cumsum(dtc * A, axis=2).astype(np.float32)
    Bc = rng.standard_normal((B, nc, Q, st)).astype(np.float32)
    Cc = rng.standard_normal((B, nc, Q, st)).astype(np.float32)
    return xc, dtc, da, Bc, Cc


SHAPES = [  # B, nc, Q, nh, hd, st
    (1, 2, 64, 4, 32, 32),      # the reduced configs' chunk and widths
    (2, 1, 40, 3, 48, 8),       # hd = 48, a chunk that is not a tile multiple
    (1, 1, 128, 2, 64, 128),    # Mamba-2-2.7B's state width
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssd_matches_reference_oracle(shape):
    args = _case(sum(shape), *shape)
    y_r, s_r = jax_ssd_ref(*(jnp.asarray(a) for a in args))
    n0 = _build.LAUNCHES["ssd"]
    y, s = ssd_chunk(*(torch.from_numpy(a) for a in args))
    assert _build.LAUNCHES["ssd"] == n0      # CPU tensors: the plain version
    assert_close(y, y_r)
    assert_close(s, s_r)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_ssd_matches_interpret_mode_pallas(shape):
    args = _case(7 + sum(shape), *shape)
    y_p, s_p = jax_ssd_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    y, s = ssd_chunk_ref(*(torch.from_numpy(a) for a in args))
    assert_close(y, y_p)
    assert_close(s, s_p)


def test_masked_before_exp():
    """A steep decay (da falls by 100 per step) overflows exp above the
    diagonal unless it is masked first: the result stays finite."""
    xc, dtc, _, Bc, Cc = _case(0, 1, 1, 16, 2, 8, 8)
    da = -100.0 * np.arange(16, dtype=np.float32)[None, None, :, None].repeat(2, -1)
    y, s = ssd_chunk(*(torch.from_numpy(a) for a in (xc, dtc, da, Bc, Cc)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as the kernel's cvt.rna.tf32.f32 does: to nearest,
    ties away from zero, on the 13 low mantissa bits (adding half of the
    last kept bit to the magnitude bits, then clearing the 13)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on TF32 tensor cores, f32 accumulate: one pass (a_hi b_hi) or
    the kernel's three (a_lo b_hi + a_hi b_lo + a_hi b_hi, a = a_hi + a_lo
    with a_hi = tf32(a), a_lo = tf32(a - a_hi)). Products of TF32 values
    are exact in f32, so torch's f32 matmul emulates the unit."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _ssd_tf32(xc, dtc, da, Bc, Cc, passes):
    """csrc/ssd.cu's arithmetic for one chunk (B = nc = 1): C B^T, then per
    head y = M' x with M' = CB exp(da_i - da_j) dt_j masked before the exp,
    and the state (x w)^T B with w = dt exp(da_last - da); each product in
    split TF32."""
    x, dt, a, bm, cm = xc[0, 0], dtc[0, 0], da[0, 0], Bc[0, 0], Cc[0, 0]
    Q, nh, _ = x.shape
    cb = _tf32_product(cm, bm.T, passes)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    ys, states = [], []
    for h in range(nh):
        seg = a[:, None, h] - a[None, :, h]
        m = torch.where(causal, cb * torch.exp(torch.where(causal, seg, 0.0))
                        * dt[None, :, h], 0.0)
        ys.append(_tf32_product(m, x[:, h], passes))
        w = dt[:, h] * torch.exp(a[-1, h] - a[:, h])
        states.append(_tf32_product((x[:, h] * w[:, None]).T, bm, passes))
    return torch.stack(ys, 1)[None, None], torch.stack(states)[None, None]


def test_split_tf32_keeps_the_f32_contract():
    """The kernel's split-TF32 products, emulated in torch on a served-size
    chunk (Q=256, hd=st=64): y and the state within 1e-5 of the largest
    magnitude of the f32 plain version's; one TF32 pass (the 3 decimal
    digits a plain TF32 product keeps) is not, which is what the split
    guards."""
    args = [torch.from_numpy(a) for a in _case(15, 1, 1, 256, 4, 64, 64)]
    y_r, s_r = ssd_chunk_ref(*args)
    y3, s3 = _ssd_tf32(*args, passes=3)
    y1, s1 = _ssd_tf32(*args, passes=1)
    assert_close(y3, y_r)
    assert_close(s3, s_r)
    for port, ref in ((y1, y_r), (s1, s_r)):
        err = float((port - ref).abs().max())
        assert err > TOL * float(ref.abs().max())


def test_tf32_rounds_to_nearest_ties_away():
    """_tf32 keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds away from
    zero to 1 + 2^-10, 1 + 2^-12 to 1, and the sign rides along."""
    v = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11), 3.0],
                     dtype=torch.float32)
    assert _tf32(v).tolist() == [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 3.0]


def test_ssd_chunk_rejects_mismatched_shapes():
    xc, dtc, da, Bc, Cc = (torch.from_numpy(a) for a in _case(0, 1, 1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="expected shape"):
        ssd_chunk(xc, dtc, da, Bc[..., :4], Cc)


@pytest.mark.parametrize("S,chunk", [(128, 64), (96, 32), (40, 40)])
def test_chunked_scan_matches_reference(S, chunk):
    """The intra-chunk step plus the recurrence over chunks."""
    rng = np.random.default_rng(S)
    B, nh, hd, st = 2, 3, 16, 8
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (B, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (nh,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, st)).astype(np.float32)
    Cm = rng.standard_normal((B, S, st)).astype(np.float32)
    y_r, s_r = jax_layers._ssd_chunked_scan(*(jnp.asarray(a) for a in
                                              (xh, dt, A, Bm, Cm)), chunk)
    y, s = layers._ssd_chunked_scan(*(torch.from_numpy(a) for a in
                                      (xh, dt, A, Bm, Cm)), chunk)
    assert_close(y, y_r)
    assert_close(s, s_r)


def test_chunked_scan_needs_whole_chunks():
    x = torch.zeros(1, 100, 2, 8)
    with pytest.raises(ValueError, match="multiple of its chunk"):
        layers._ssd_chunked_scan(x, torch.zeros(1, 100, 2), -torch.ones(2),
                                 torch.zeros(1, 100, 4), torch.zeros(1, 100, 4), 64)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba-2 mixer of the reduced Mamba-2-2.7B (Q=64, hd=st=32,
    nh=16), its parameters drawn by the reference and converted."""
    jcfg = jax_get_arch("mamba2-2.7b").reduced()
    p = jax.jit(lambda k: jax_layers.mamba_init(k, jcfg, jnp.float32))(
        jax.random.PRNGKey(3))
    p_np = jax.tree.map(np.asarray, p)
    # a non-zero bias and dt_bias so both paths see them
    rng = np.random.default_rng(3)
    for name in ("conv_x_b", "conv_bc_b", "dt_bias"):
        p_np[name] = (0.1 * rng.standard_normal(p_np[name].shape)).astype(np.float32)
    cfg = get_arch("mamba2-2.7b").reduced()
    port = layers.Params({k: convert.tensor(v, "cpu") for k, v in p_np.items()})
    fwd = jax.jit(lambda p, x, st: jax_layers.mamba_forward(
        p, x, jcfg, jax_layers.Sharder(), state=st))
    return jcfg, cfg, jax.tree.map(jnp.asarray, p_np), port, fwd


def test_mamba_forward_chunked_matches_reference(mixer):
    jcfg, cfg, p_j, p_t, fwd = mixer
    x = np.random.default_rng(0).standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    y_r, st_r = fwd(p_j, jnp.asarray(x), None)
    y, st = layers.mamba_forward(p_t, torch.from_numpy(x), cfg)
    assert_close(y, y_r, 2 * TOL)
    assert_close(st["conv"], st_r["conv"])
    assert_close(st["ssm"], st_r["ssm"], 2 * TOL)


def test_mamba_forward_recurrent_matches_reference(mixer):
    """Three single-token steps from a non-zero state, updated in place."""
    jcfg, cfg, p_j, p_t, fwd = mixer
    rng = np.random.default_rng(1)
    state_np = {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
                for k, v in layers.init_ssm_state(cfg, 1, 2, torch.float32,
                                                  "cpu").items()}
    state_j = jax.tree.map(jnp.asarray, state_np)
    state_t = {k: torch.from_numpy(v.copy()) for k, v in state_np.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y_r, state_j = fwd(p_j, jnp.asarray(x), state_j)
        y, _ = layers.mamba_forward(p_t, torch.from_numpy(x), cfg, state=state_t)
        assert_close(y, y_r, 2 * TOL)
        for k in ("conv", "ssm"):
            assert_close(state_t[k], state_j[k], 2 * TOL)


def test_trailing_layout_config_counts():
    """A 5-layer Zamba2 variant has 2 grouped Mamba-2 layers, one shared
    application and one trailing layer, in both packages."""
    from repro.models.decoder import _hybrid_counts as jax_counts
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), num_layers=5)
    jcfg = dataclasses.replace(jax_get_arch("zamba2-7b").reduced(), num_layers=5)
    assert cfg.hybrid_counts == jax_counts(jcfg) == (2, 1, 1)
    assert get_arch("zamba2-7b").hybrid_counts == (13, 5, 3)
    assert (get_arch("zamba2-7b").reduced().hybrid_counts
            == jax_counts(jax_get_arch("zamba2-7b").reduced()))
