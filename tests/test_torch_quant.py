"""The port's int8 quant kernels (their plain versions, on the CPU) against
the JAX package's: the reference's op-identical oracle, its Pallas kernel
bodies, and its Pallas kernels in interpret mode, fed the same numpy x and
uniforms.

The int8 codes and f32 scales are the wire format, so parity is equality,
bit for bit: both sides compute scale = max|x| / 127 and floor(x / scale
+ u) with IEEE divisions, in f32, from the same inputs.

One exception, a fault of the reference: compiled by XLA on the CPU (under
jit, and so in interpret-mode Pallas), ``amax / 127.0`` becomes
``amax * fl(1/127)``, one ulp off the quotient its source writes in some
chunks. The eager oracle and the kernel body run op by op keep the
quotient. Against interpret-mode Pallas the port is therefore held
bit-exact on every chunk where the two scales agree; on the other chunks
the Pallas scale is shown to be exactly that rewrite, and the Pallas codes
and outputs are held bit for bit to floor(x / s + u) and q * s from that
scale s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant.ops import dequantize_2d, quantize_2d
from repro.kernels.quant.quant import (ROW_TILE, _dequantize_kernel,
                                       _quantize_kernel)
from repro.kernels.quant.ops import int8_sr_encode as jax_encode
from repro.kernels.quant.ops import int8_sr_roundtrip as jax_roundtrip
from repro.kernels.quant.ref import dequantize_ref as jax_dequantize_ref
from repro.kernels.quant.ref import quantize_ref as jax_quantize_ref
from repro_torch.kernels.quant import (chunk_rows, dequantize, dequantize_ref,
                                       int8_dequantize, int8_sr_encode,
                                       int8_sr_roundtrip, quantize,
                                       quantize_ref)

from torch_threads import one_torch_thread  # noqa: F401


def _chunks(rng, K, nc, C):
    """x [K, nc, C] with the corner cases: an all-zero chunk, a chunk whose
    values sit on code points (x/scale hits ±127 and every code between),
    and chunks of very different magnitudes."""
    x = rng.standard_normal((K, nc, C)).astype(np.float32)
    x *= (10.0 ** rng.integers(-4, 5, (K, nc, 1))).astype(np.float32)
    x[0, 0] = 0.0
    codes = np.arange(C) % 255 - 127
    x[-1, -1] = (codes * 0.5).astype(np.float32)    # scale 0.5 exactly
    u = rng.uniform(0.0, 1.0, (K, nc, C)).astype(np.float32)
    return x, u


def _kernel_body_eager(x, u):
    """The reference's Pallas kernel bodies run op by op on numpy buffers,
    one ROW_TILE-row grid step at a time over the padded chunk rows."""
    nc, C = x.shape
    pad = -nc % ROW_TILE
    xp, up = (np.pad(a, ((0, pad), (0, 0))) for a in (x, u))
    q = np.zeros(xp.shape, np.int8)
    s = np.ones((xp.shape[0], 1), np.float32)
    out = np.zeros(xp.shape, np.float32)
    for r in range(0, xp.shape[0], ROW_TILE):
        t = slice(r, r + ROW_TILE)
        _quantize_kernel(xp[t], up[t], q[t], s[t])
        _dequantize_kernel(q[t], s[t], out[t])
    return q[:nc], s[:nc], out[:nc]


@pytest.mark.parametrize("nc", [1, 8, 13])
def test_quantize_bit_exact_with_reference_oracle_and_kernel_body(nc):
    K, C = 3, 256
    x, u = _chunks(np.random.default_rng(nc), K, nc, C)
    q, s = quantize(torch.from_numpy(x), torch.from_numpy(u))
    out = dequantize(q, s)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (K, nc, 1)
    for k in range(K):
        qr, sr = jax_quantize_ref(jnp.asarray(x[k]), jnp.asarray(u[k]))
        dr = jax_dequantize_ref(qr, sr)
        qb, sb, db = _kernel_body_eager(x[k], u[k])
        for ref_q, ref_s, ref_out in ((qr, sr, dr), (qb, sb, db)):
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(ref_q))
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(ref_s))
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref_out))
    # the corner cases are in the data: a zero chunk decodes to exact zeros
    # with scale 1, the code-point chunk is lossless and reaches ±127
    assert s[0, 0, 0] == 1.0 and not out[0, 0].any()
    assert torch.equal(out[-1, -1], torch.from_numpy(x[-1, -1]))
    assert int(q[-1, -1].max()) == 127 and int(q[-1, -1].min()) == -127


@pytest.mark.parametrize("nc", [1, 8, 13, 64])
def test_quantize_against_interpret_mode_pallas(nc):
    """Bit-exact on every chunk whose XLA-compiled scale is the quotient;
    the rest carry exactly amax * fl(1/127), and their codes and outputs
    are the plain version's arithmetic from that scale (see the module
    docstring)."""
    K, C = 3, 256
    x, u = _chunks(np.random.default_rng(100 + nc), K, nc, C)
    q, s = quantize(torch.from_numpy(x), torch.from_numpy(u))
    out = dequantize(q, s)
    agreed = 0
    for k in range(K):
        qp, sp = quantize_2d(jnp.asarray(x[k]), jnp.asarray(u[k]),
                             use_pallas=True, interpret=True)
        dp = np.asarray(dequantize_2d(qp, sp, use_pallas=True, interpret=True))
        qp, sp = np.asarray(qp), np.asarray(sp)
        amax = np.abs(x[k]).max(-1, keepdims=True)
        recip = np.where(amax > 0, amax * np.float32(1 / np.float32(127)),
                         np.float32(1)).astype(np.float32)
        np.testing.assert_array_equal(sp, recip)
        same = (sp == s[k].numpy())[:, 0]
        agreed += int(same.sum())
        np.testing.assert_array_equal(q[k].numpy()[same], qp[same])
        np.testing.assert_array_equal(out[k].numpy()[same], dp[same])
        np.testing.assert_array_equal(
            np.abs(np.float32(1) - sp[~same] / s[k].numpy()[~same])
            <= np.finfo(np.float32).eps, True)
        # every chunk gets a code comparison: from the Pallas scale, the
        # plain version's floor(x / s + u), clip, and q * s
        q_sp = np.clip(np.floor(x[k] / sp + u[k]), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(qp, q_sp)
        np.testing.assert_array_equal(dp, qp.astype(np.float32) * sp)
    assert agreed > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,chunk", [(54, 256), (1000, 256), (300, 64)])
def test_flat_encode_matches_reference_with_its_draws(n, chunk, dtype):
    """int8_sr_encode of [K, n] (padded to whole chunks, f64 rounded to f32)
    against the reference's flat entry points, which draw u from a key:
    the port is handed the same draws. The reference runs op by op
    (jax.disable_jit), where its scale is the quotient (module docstring)."""
    K = 4
    rng = np.random.default_rng(n + chunk)
    x = rng.standard_normal((K, n)).astype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    nc = chunk_rows(n, chunk)
    u = np.stack([np.asarray(jax.random.uniform(keys[k], (nc, chunk),
                                                jnp.float32))
                  for k in range(K)])
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    q, s = int8_sr_encode(tx, tu)
    dec = int8_dequantize(q, s, n)
    rt = int8_sr_roundtrip(tx, tu)
    assert dec.dtype == torch.float32 and rt.dtype == tx.dtype
    for k in range(K):
        xk = jnp.asarray(x[k], jnp.float32)
        with jax.disable_jit():
            qr, sr = jax_encode(xk, keys[k], chunk=chunk, use_pallas=False)
            ref = np.asarray(jax_roundtrip(xk, keys[k], chunk=chunk,
                                           use_pallas=False))
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(qr))
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(sr))
        np.testing.assert_array_equal(dec[k].numpy(), ref)
        np.testing.assert_array_equal(rt[k].numpy(), ref.astype(dtype))


def test_uniforms_must_cover_the_upload():
    x = torch.zeros(2, 300)
    with pytest.raises(ValueError, match="does not cover"):
        int8_sr_encode(x, torch.zeros(2, 1, 256))
    with pytest.raises(ValueError, match="differ"):
        quantize(torch.zeros(2, 1, 256), torch.zeros(2, 2, 256))


def test_plain_version_is_the_reference_oracle_op_for_op():
    """The plain version divides by the scale: a multiply by its reciprocal
    would move some codes by one."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (64, 256)).astype(np.float32))
    q, s = quantize_ref(x, u)
    recip = torch.clamp(torch.floor(x * (1.0 / s) + u), -127, 127).to(torch.int8)
    assert not torch.equal(q, recip)
    np.testing.assert_array_equal(dequantize_ref(q, s).numpy(),
                                  q.numpy().astype(np.float32) * s.numpy())
