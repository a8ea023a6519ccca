"""The port's CUDA kernels against their plain PyTorch versions, on an
H100. Marked ``cuda``: they skip where there is no card of compute
capability 9.x. This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The trajectory, Gram and update kernels differ from their plain versions
only in summation order: max |kernel - plain| <= tol * max |plain| (or,
where the result may cancel, tol times the largest sum of its terms'
magnitudes) with tol 1e-12 in float64 and 1e-5 in float32 (chained
trajectory steps; Gram sums 1000 terms long). The fused AA step is held
the same way against its plain version (the same Jacobi and sums op for
op): w+ against its terms, gamma, |gamma| and cond against their largest
magnitude, theta^2 absolutely, used and clipped exactly. The quant kernels sum
nothing and divide as IEEE does: their codes, scales and outputs equal the
plain version's bit for bit, from the same uniforms; so do the fused int8
uplink's outputs, every step of its arithmetic rounded as the plain
version's torch ops round it.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.codecs import Codec, Int8SRCodec
from repro_torch.kernels import _build
from repro_torch.kernels.anderson import aa_step, flat_gram, flat_update
from repro_torch.kernels.anderson.ref import (aa_step_ref, clip_keep_ref,
                                              gram_ref, update_ref)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.kernels.local_update.ops import (inverse_count,
                                                  plan_trajectory,
                                                  resident_smem_bytes)
from repro_torch.kernels.local_update.ref import trajectory_ref
from repro_torch.kernels.quant import (chunk_rows, dequantize, dequantize_ref,
                                       int8_dequantize, int8_sr_encode,
                                       int8_sr_uplink, int8_sr_uplink_ref,
                                       quantize, quantize_ref)
from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_ref

from torch_threads import one_torch_thread  # noqa: F401

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def card():
    """An H100-class card (compute capability 9.x), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def assert_close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def assert_bf16_steps(port, ref):
    """Every element of a bf16 result within one bf16 step of the plain
    version's: |port - ref| <= 2^-7 |ref| + 2^-9 of the RMS of ref's row
    over the last dim (the f32 sums' own error where a row cancels)."""
    port, ref = port.float().cpu(), ref.float().cpu()
    assert port.shape == ref.shape
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    excess = (port - ref).abs() - (2.0 ** -7 * ref.abs() + 2.0 ** -9 * rms)
    assert float(excess.max()) <= 0.0, float(excess.max())


def _traj_case(rng, K, S, n, d, link, dtype):
    x = rng.standard_normal((K, S, n, d)).astype(dtype)
    if link == "logistic":
        y = rng.choice([-1.0, 1.0], (K, S, n)).astype(dtype)
    else:
        y = rng.standard_normal((K, S, n)).astype(dtype)
    mask = np.ones((K, S, n), dtype)
    mask[1, :, n - 5:] = 0.0            # a ragged client
    w0 = (0.1 * rng.standard_normal((K, d))).astype(dtype)
    u = (0.01 * rng.standard_normal((K, d))).astype(dtype)
    return x, y, mask, w0, u


def _aa_case(rng, K, m, d, dtype):
    y = rng.standard_normal((K, m, d)).astype(dtype)
    s = rng.standard_normal((K, m, d)).astype(dtype)
    g = rng.standard_normal(d).astype(dtype)
    w = rng.standard_normal(d).astype(dtype)
    gamma = rng.standard_normal((K, m)).astype(dtype)
    return y, s, g, w, gamma


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("link", ["logistic", "linear"])
@pytest.mark.parametrize("anchor", [0.0, 1.0])
@pytest.mark.parametrize("per_step", [False, True])
def test_trajectory_kernel_on_card(card, dtype, link, anchor, per_step):
    steps = 5
    S = steps if per_step else 1
    rng = np.random.default_rng(11)
    npd = np.float64 if dtype == torch.float64 else np.float32
    x, y, mask, w0, u = (torch.from_numpy(a).to(card) for a in _traj_case(
        rng, 7, S, 333, 54, link, npd))
    kw = dict(link=link, reg=1e-3, eta=0.5, anchor_scale=anchor, steps=steps)
    n0 = _build.LAUNCHES["trajectory"]
    design = "streaming" if per_step else "resident"
    d0 = _build.DESIGN_LAUNCHES["trajectory"][design]
    w_k, r_k = fused_trajectory(x, y, mask, w0, u, **kw)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["trajectory"] == n0 + 1
    assert _build.DESIGN_LAUNCHES["trajectory"][design] == d0 + 1
    w_p, r_p = trajectory_ref(x, y, mask, w0, u, inverse_count(mask, dtype),
                              **kw)
    tol = TOL[npd]
    assert_close(w_k.cpu(), w_p.cpu(), tol)
    assert_close(r_k.cpu(), r_p.cpu(), tol)
    w_2, r_2 = fused_trajectory(x, y, mask, w0, u, **kw)
    assert torch.equal(w_k, w_2) and torch.equal(r_k, r_2)


def _rows_for_cluster(cluster, d, dtype):
    """A client's row count whose resident plan at K=70 (too many clients
    for the clusters to grow) takes ``cluster`` blocks, 3 short of filling
    them (so, past one block, n is no multiple of the rows per block)."""
    size = torch.empty((), dtype=dtype).element_size()
    most = 1
    while resident_smem_bytes(most + 1, d, size) <= 232_448:
        most += 1
    return cluster * most - 3 if cluster > 1 else most - 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [54, 37])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_trajectory_resident_clusters_on_card(card, dtype, d, cluster):
    """The resident design at every cluster size, on a shape whose rows
    fill the blocks but for 3 (a ragged last block), with a ragged and a
    fully masked client: every (link, a) against the plain version, one
    launch each on the resident design, bit-identical when run again."""
    K, steps = 70, 4
    n = _rows_for_cluster(cluster, d, dtype)
    plan = plan_trajectory(K, 1, n, d, dtype)
    assert (plan.design, plan.cluster) == ("resident", cluster)
    assert cluster == 1 or n % plan.rows_per_block
    npd = np.float64 if dtype == torch.float64 else np.float32
    for link in ("logistic", "linear"):
        rng = np.random.default_rng(cluster * d)
        x, y, mask, w0, u = (torch.from_numpy(a).to(card) for a in _traj_case(
            rng, K, 1, n, d, link, npd))
        mask[2] = 0.0                    # a client with no valid row
        for anchor in (0.0, 1.0):
            kw = dict(link=link, reg=1e-3, eta=0.5, anchor_scale=anchor,
                      steps=steps)
            d0 = dict(_build.DESIGN_LAUNCHES["trajectory"])
            w_k, r_k = fused_trajectory(x, y, mask, w0, u, **kw)
            w_2, r_2 = fused_trajectory(x, y, mask, w0, u, **kw)
            torch.cuda.synchronize(card)
            assert _build.DESIGN_LAUNCHES["trajectory"] == {
                "resident": d0["resident"] + 2, "streaming": d0["streaming"]}
            assert torch.equal(w_k, w_2) and torch.equal(r_k, r_2)
            w_p, r_p = trajectory_ref(x, y, mask, w0, u,
                                      inverse_count(mask, dtype), **kw)
            assert_close(w_k.cpu(), w_p.cpu(), TOL[npd])
            assert_close(r_k.cpu(), r_p.cpu(), TOL[npd])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shared", [True, False])
def test_anderson_kernels_on_card(card, dtype, shared):
    npd = np.float64 if dtype == torch.float64 else np.float32
    K, m, d = 9, 10, 1000
    y, s, g, w, gamma = (torch.from_numpy(a).to(card) for a in _aa_case(
        np.random.default_rng(12), K, m, d, npd))
    if not shared:
        g, w = g.expand(K, d).contiguous(), w.expand(K, d) + 1.0
    # float32 sums of d=1000 terms carry ~sqrt(1000) ulps
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    gram_k, yg_k = flat_gram(y, g)
    gram_p, yg_p = gram_ref(y, g)
    assert_close(gram_k.cpu(), gram_p.cpu(), tol)
    # Y g and the update may cancel: their error scales with |terms|
    ya, ga = y.abs(), gamma.abs().unsqueeze(-2)
    err = (yg_k - yg_p).abs().max()
    assert err <= tol * (ya @ g.abs().expand(K, d).unsqueeze(-1)).max()
    new_k = flat_update(w, g, s, y, gamma, 0.7, 0.9)
    new_p = update_ref(w, g, s, y, gamma, 0.7, 0.9)
    scale = w.abs() + 0.7 * g.abs() + 0.9 * (ga @ s.abs() + 0.7 * (ga @ ya)
                                             ).squeeze(-2)
    assert (new_k - new_p).abs().max() <= tol * scale.max()
    with pytest.raises(ValueError, match="expected shape"):
        flat_gram(y, g[..., :-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 10, 64])
@pytest.mark.parametrize("d", [54, 2048, 2 ** 20 + 3])
def test_gram_kernel_shapes_on_card(card, dtype, m, d):
    """The Gram kernel from one history column to MAX_HISTORY, from the main
    path's d=54 (all of Y_k staged at once) through a tiled d to one wider
    than a block takes (about 2^14 tiles, one block a client):
    within tol of the plain version run in float64 (the exact sums to well
    under tol; in float32 at d = 2^20 the plain version's own cuBLAS
    product is farther than tol from them, the kernel's blocked sums are
    not), exactly symmetric, and bit-identical when run again."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    K = 3
    rng = np.random.default_rng(m + d)
    y = torch.from_numpy(rng.standard_normal((K, m, d)).astype(npd)).to(card)
    g = torch.from_numpy(rng.standard_normal(d).astype(npd)).to(card)
    n0 = _build.LAUNCHES["gram"]
    gram_k, yg_k = flat_gram(y, g)
    gram_k2, yg_k2 = flat_gram(y, g)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["gram"] == n0 + 2
    assert torch.equal(gram_k, gram_k2) and torch.equal(yg_k, yg_k2)
    assert torch.equal(gram_k, gram_k.transpose(1, 2))
    gram_p, yg_p = gram_ref(y.double(), g.double())
    tol = TOL[npd]
    assert_close(gram_k.cpu(), gram_p.cpu(), tol)
    err = (yg_k.double() - yg_p).abs().max()
    assert err <= tol * (y.double().abs() @ g.double().abs()).max()


#: AA-step knobs: AAConfig's defaults, and every option on
AA_KNOBS = {"defaults": dict(damping=1.0, tikhonov=1e-10, filter_rtol=0.0,
                             clip_rtol=0.0),
            "options": dict(damping=0.7, tikhonov=1e-8, filter_rtol=1e-6,
                            clip_rtol=0.5)}


def _aa_step_inputs(card, dtype, K, m, d, shared, seed):
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card, dtype=dtype)
    s, y = randn(K, m, d), randn(K, m, d)
    w, g = (randn(d), randn(d)) if shared else (randn(K, d), randn(K, d))
    return w, g, s, y


def _assert_aa_step_close(got, want, w, g, s, y, gram, eta, kw, tol):
    """w+ within tol of its terms; gamma, |gamma|, cond within tol of their
    largest magnitude; theta^2 within tol; used, clipped equal; NaN where
    the plain version has NaN."""
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    keep = clip_keep_ref(gram, kw["clip_rtol"])
    ga = torch.where(keep, torch.nan_to_num(want[1]).abs(), 0.0).unsqueeze(-2)
    scale = w.abs() + eta * g.abs() + kw["damping"] * (
        ga @ s.abs().nan_to_num(posinf=0.0) + eta * (
            ga @ y.abs().nan_to_num(posinf=0.0))).squeeze(-2)
    diff = (got[0] - want[0]).nan_to_num().abs()
    assert float(diff.max()) <= tol * float(scale.max())
    for i in (1, 3, 4):
        a, b = got[i].nan_to_num(), want[i].nan_to_num()
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)
    t2 = (got[2].nan_to_num() ** 2 - want[2].nan_to_num() ** 2).abs()
    assert float(t2.max()) <= tol
    assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("m", [1, 10, 64])
@pytest.mark.parametrize("d", [1, 54, 1000, 2 ** 20 + 3])
@pytest.mark.parametrize("knobs", sorted(AA_KNOBS))
def test_aa_step_kernel_on_card(card, dtype, shared, m, d, knobs):
    """The fused AA step against its plain version on the card, from one
    history column to MAX_HISTORY and from d=1 to a d that takes many
    update blocks a client; one launch a call; reruns bit-identical."""
    K = 3
    kw = AA_KNOBS[knobs]
    w, g, s, y = _aa_step_inputs(card, dtype, K, m, d, shared, seed=m * d)
    gram, yg = flat_gram(y, g)
    n0 = dict(_build.LAUNCHES)
    got = aa_step(w, g, s, y, gram, yg, 0.6, **kw)
    again = aa_step(w, g, s, y, gram, yg, 0.6, **kw)
    torch.cuda.synchronize(card)
    assert {k: v - n0[k] for k, v in _build.LAUNCHES.items() if v != n0[k]} == {
        "aa_step": 2}
    for a, b in zip(got, again):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    want = aa_step_ref(w, g, s, y, gram, yg, 0.6, **kw)
    assert got[0].shape == (K, d) and got[1].shape == (K, m)
    assert got[5].dtype == torch.int64
    _assert_aa_step_close(got, want, w, g, s, y, gram, 0.6, kw,
                          TOL[np.float64 if dtype == torch.float64 else np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["rank0", "all_clipped", "inf_column",
                                  "undefended_overflow", "even_median"])
def test_aa_step_degenerate_on_card(card, dtype, case):
    """The degenerate systems through the kernel, against the plain version:
    a zero history (gamma 0, the gradient step), every column screened, an
    infinite column screened, an overflow without the screen (gamma NaN,
    used 0, cond 1), and an even count of finite columns (the median
    averages the middle pair)."""
    K, m, d = 2, 6, 40
    w, g, s, y = _aa_step_inputs(card, dtype, K, m, d, True, seed=11)
    kw = dict(AA_KNOBS["defaults"], clip_rtol=1e-3)
    if case == "rank0":
        y = torch.zeros_like(y)
    elif case == "all_clipped":
        s, y = torch.full_like(s, torch.inf), torch.full_like(y, torch.inf)
    elif case == "inf_column":
        s[0, 2], y[0, 2] = torch.inf, -torch.inf
    elif case == "undefended_overflow":
        y[1, 4] *= 1e200 if dtype == torch.float64 else 1e24
        kw["clip_rtol"] = 0.0
    else:
        # four finite norms 1, 2, 3, 3.5 (median 2.5) and two infinite ones:
        # clip_rtol 0.8 keeps 3 (2.4 <= 2.5) and drops 3.5
        scale = torch.tensor([1.0, 2.0, 3.0, 3.5, torch.inf, torch.inf],
                             dtype=dtype, device=card)
        y = y / y.norm(dim=-1, keepdim=True) * scale[:, None]
        kw["clip_rtol"] = 0.8
    gram, yg = flat_gram(y, g)
    got = aa_step(w, g, s, y, gram, yg, 0.6, **kw)
    want = aa_step_ref(w, g, s, y, gram, yg, 0.6, **kw)
    _assert_aa_step_close(got, want, w, g, s, y, gram, 0.6, kw,
                          TOL[np.float64 if dtype == torch.float64 else np.float32])
    if case in ("rank0", "all_clipped"):
        assert torch.equal(got[0], (w - g * 0.6).expand(K, d))
        assert int(got[5].max()) == 0
    if case == "undefended_overflow":
        assert bool(torch.isnan(got[1][1]).all()) and int(got[5][1]) == 0
        assert float(got[4][1]) == 1.0 and bool(torch.isfinite(got[0][0]).all())
    if case == "inf_column":
        assert int(got[6][0]) == 1 and bool(torch.isfinite(got[0]).all())
    if case == "even_median":
        assert got[6].tolist() == [3, 3]


@pytest.mark.cuda
def test_aa_step_wrapper_raises_on_what_the_kernel_does_not_take(card):
    w, g, s, y = _aa_step_inputs(card, torch.float32, 2, 3, 50, True, seed=1)
    gram, yg = flat_gram(y, g)
    kw = AA_KNOBS["defaults"]
    with pytest.raises(TypeError, match="one dtype"):
        aa_step(w.double(), g, s, y, gram, yg, 0.5, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        aa_step(*(t.bfloat16() for t in (w, g, s, y, gram, yg)), 0.5, **kw)
    with pytest.raises(ValueError, match="shapes"):
        aa_step(w, g, s, y[:, :2], gram, yg, 0.5, **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        aa_step(w, g, s.transpose(0, 1).contiguous().transpose(0, 1), y, gram,
                yg, 0.5, **kw)
    big = torch.zeros(2, 65, 50, device=card)
    with pytest.raises(ValueError, match="history columns"):
        aa_step(w, g, big, big, torch.zeros(2, 65, 65, device=card),
                torch.zeros(2, 65, device=card), 0.5, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,n,chunk", [(100, 54, 256), (7, 1000, 256),
                                       (3, 4097, 64), (5, 300, 1000),
                                       (2, 33, 20)])
def test_quant_kernels_on_card(card, x_dtype, K, n, chunk):
    """Encode and decode of every client's [n] upload (ragged last chunk,
    f64 converted on load), against the plain version on the same draws."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((K, n)) * 10.0 ** rng.integers(-3, 4, (K, 1))
    x[0] = 0.0                                     # an all-zero client
    x = torch.from_numpy(x).to(card, x_dtype)
    nc = chunk_rows(n, chunk)
    u = torch.rand((K, nc, chunk), generator=torch.Generator(
        device=card).manual_seed(n), device=card)
    n0 = dict(_build.LAUNCHES)
    q, s = int8_sr_encode(x, u)
    out = int8_dequantize(q, s, n, x_dtype)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["quantize"] == n0["quantize"] + 1
    assert _build.LAUNCHES["dequantize"] == n0["dequantize"] + 1
    xp = torch.nn.functional.pad(x.cpu().to(torch.float32), (0, nc * chunk - n))
    q_p, s_p = quantize_ref(xp.reshape(K, nc, chunk), u.cpu())
    assert torch.equal(q.cpu(), q_p) and torch.equal(s.cpu(), s_p)
    # the plain version on the card divides as IEEE does there too
    q_c, s_c = quantize_ref(xp.reshape(K, nc, chunk).to(card), u)
    assert torch.equal(q_c.cpu(), q_p) and torch.equal(s_c.cpu(), s_p)
    out_p = dequantize_ref(q_p, s_p).reshape(K, -1)[:, :n].to(x_dtype)
    assert torch.equal(out.cpu(), out_p)
    # the batched [..., nc, C] entry points, on the padded grid
    q2, s2 = quantize(xp.reshape(K, nc, chunk).to(card), u)
    assert torch.equal(q2.cpu(), q_p) and torch.equal(s2.cpu(), s_p)
    assert torch.equal(dequantize(q2, s2).cpu(), dequantize_ref(q_p, s_p))


@pytest.mark.cuda
def test_quant_wrappers_raise_on_what_the_kernel_does_not_take(card):
    x = torch.zeros(2, 300, device=card)
    with pytest.raises(TypeError, match="takes"):
        int8_sr_encode(x, torch.zeros(2, 2, 256, device=card,
                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="chunk <= 1024"):
        int8_sr_encode(torch.zeros(2, 3000, device=card),
                       torch.zeros(2, 2, 2048, device=card))
    with pytest.raises(ValueError, match="does not cover"):
        int8_sr_encode(x, torch.zeros(2, 1, 256, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,n,chunk", [(100, 54, 256), (5, 300, 256),
                                       (3, 768, 256), (3, 4097, 64),
                                       (2, 33, 1000)])
@pytest.mark.parametrize("anchor,ref,ef", [
    (a, r, e) for a in (False, True) for r in (False, True)
    for e in (False, True)])
def test_int8_uplink_kernel_on_card(card, x_dtype, K, n, chunk, anchor, ref,
                                    ef):
    """The fused uplink (one launch, no quantize or dequantize launch)
    against its plain version on the CPU and on the card, and against the
    two-launch composition (Codec.uplink around Int8SRCodec.roundtrip), bit
    for bit, for every set of buffers; client 0's upload is all zeros; a
    rerun is bit-identical."""
    rng = np.random.default_rng(n + chunk)
    x = rng.standard_normal((K, n)) * 10.0 ** rng.integers(-3, 4, (K, 1))
    a = rng.standard_normal(n) if anchor else None
    r = 0.1 * rng.standard_normal((K, n)) if ref else None
    e = 1e-3 * rng.standard_normal((K, n)) if ef else None
    x[0] = a if anchor else 0.0
    for buf in (r, e):
        if buf is not None:
            buf[0] = 0.0
    x, a, r, e = (None if t is None else torch.from_numpy(t).to(card, x_dtype)
                  for t in (x, a, r, e))
    u = torch.rand((K, chunk_rows(n, chunk), chunk), generator=torch.Generator(
        device=card).manual_seed(n), device=card)
    n0 = dict(_build.LAUNCHES)
    out = int8_sr_uplink(x, u, a, r, e)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES == {**n0, "int8_uplink": n0["int8_uplink"] + 1}
    cpu = [None if t is None else t.cpu() for t in (x, u, a, r, e)]
    want = int8_sr_uplink_ref(*cpu)
    on_card = int8_sr_uplink_ref(x, u, a, r, e)
    composed = Codec.uplink(Int8SRCodec(chunk=chunk), x, u, a, r, e)
    rerun = int8_sr_uplink(x, u, a, r, e)
    for o, w, *others in zip(out, want, on_card, composed, rerun):
        assert (o is None) == (w is None)
        if o is None:
            continue
        assert o.dtype == x_dtype and torch.equal(o.cpu(), w)
        for other in others:
            assert torch.equal(other, o)
    if ref and not anchor:
        assert out[2] is out[0]
    assert (out[1] is None) == (not ef) and (out[2] is None) == (not ref)


@pytest.mark.cuda
def test_int8_uplink_wrapper_raises_on_what_the_kernel_does_not_take(card):
    x = torch.zeros(2, 300, device=card)
    u = torch.zeros(2, 2, 256, device=card)
    with pytest.raises(TypeError, match="takes"):
        int8_sr_uplink(x.to(torch.bfloat16), u)
    with pytest.raises(TypeError, match="takes"):
        int8_sr_uplink(x, u.double())
    with pytest.raises(TypeError, match="ref is"):
        int8_sr_uplink(x, u, ref=x.double())
    with pytest.raises(ValueError, match="anchor"):
        int8_sr_uplink(x, u, anchor=x)
    with pytest.raises(ValueError, match="chunk <= 1024"):
        int8_sr_uplink(torch.zeros(2, 3000, device=card),
                       torch.zeros(2, 2, 2048, device=card))
    with pytest.raises(ValueError, match="not contiguous"):
        int8_sr_uplink(torch.zeros(300, 2, device=card).t(), u)
    with pytest.raises(ValueError, match="does not cover"):
        int8_sr_uplink(x, torch.zeros(2, 1, 256, device=card))


@pytest.mark.cuda
def test_noop_launches_and_counts_nowhere(card):
    """The launch-floor kernel launches through the kernels' own path and
    adds to no kernel's count."""
    n0 = dict(_build.LAUNCHES)
    d0 = {k: dict(v) for k, v in _build.DESIGN_LAUNCHES.items()}
    for _ in range(3):
        _build.noop()
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES == n0
    assert _build.DESIGN_LAUNCHES == d0


def _ssd_case(rng, B, nc, Q, nh, hd, st):
    xc = rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32)
    dtc = rng.uniform(0.01, 0.3, (B, nc, Q, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (nh,)).astype(np.float32)
    da = np.cumsum(dtc * A, axis=2).astype(np.float32)
    Bc = rng.standard_normal((B, nc, Q, st)).astype(np.float32)
    Cc = rng.standard_normal((B, nc, Q, st)).astype(np.float32)
    return xc, dtc, da, Bc, Cc


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,nh,hd,st", [
    (1, 2, 64, 16, 32, 32),        # reduced configs
    (1, 2, 256, 8, 64, 64),        # Zamba2-7B's chunk and widths
    (1, 1, 256, 4, 64, 128),       # Mamba-2-2.7B's state
    (2, 1, 100, 3, 48, 20),        # ragged tiles: Q, hd, st not multiples of 16/64
    (1, 3, 17, 2, 128, 128),       # the widest head and state, a tiny chunk
    (1, 1, 256, 112, 64, 64),      # Zamba2-7B's full head count, one chunk
])
def test_ssd_kernel_on_card(card, B, nc, Q, nh, hd, st):
    """f32 intra-chunk step against its plain version on the card; the two
    differ in summation order and the kernel's split-TF32 products (three
    passes keep ~2^-22), within 1e-5 of the largest magnitude; a rerun is
    bit-identical."""
    args = [torch.from_numpy(a).to(card) for a in _ssd_case(
        np.random.default_rng(Q + st), B, nc, Q, nh, hd, st)]
    n0 = _build.LAUNCHES["ssd"]
    y, state = ssd_chunk(*args)
    y2, state2 = ssd_chunk(*args)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["ssd"] == n0 + 2
    assert torch.equal(y, y2) and torch.equal(state, state2)
    y_p, state_p = ssd_chunk_ref(*args)
    assert_close(y.cpu(), y_p.cpu(), 1e-5)
    assert_close(state.cpu(), state_p.cpu(), 1e-5)
    assert _build.LAUNCHES["ssd"] == n0 + 2      # the plain version counts none


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 128, 4, 2, 64, 0),         # reduced GQA
    (1, 200, 4, 4, 112, 0),        # Zamba2's head dim, ragged S
    (2, 333, 4, 1, 48, 64),        # MQA, window, ragged S
    (1, 64, 2, 2, 128, 16),        # the widest head, window inside a block
    (1, 5, 3, 3, 8, 0),            # fewer rows than a block
])
def test_flash_kernel_on_card(card, dtype, B, S, H, KV, hd, window):
    """Kernel vs plain version in the model layout; both compute in f32 and
    round once to ``dtype`` (1e-5 of the largest |out| in f32; in bf16 two
    roundings of an f32 value apart: 2^-7, and each element within one bf16
    step). The bf16 kernel takes head dims that are a multiple of 16 only:
    for others the wrapper raises."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(card, dtype) for shape in ((B, S, H, hd), (B, S, KV, hd),
                                              (B, S, KV, hd)))
    n0 = _build.LAUNCHES["flash_attention"]
    if dtype == torch.bfloat16 and hd % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            flash_attention(q, k, v, window=window)
        assert _build.LAUNCHES["flash_attention"] == n0
        return
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["flash_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_ref(q, k, v, window=window)
    assert_close(out.float().cpu(), ref.float().cpu(),
                 1e-5 if dtype == torch.float32 else 2 ** -7)
    if dtype == torch.bfloat16:
        assert_bf16_steps(out, ref)
    # the first token attends to itself only
    torch.testing.assert_close(out[:, 0].float(), v[:, 0].repeat_interleave(
        H // KV, dim=1).float(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("window", [0, 7, 200])
@pytest.mark.parametrize("S", [1, 17, 64, 1000])
def test_flash_bf16_tensor_core_kernel_on_card(card, hd, window, S):
    """The bf16 tensor-core kernel at the served head dims, GQA (H=8 on
    KV=2), causal with and without a window (one the width of a few rows,
    one across tiles), S from one row to a ragged many-tile length: within
    2^-7 of the plain version's largest |out| and every element within one
    bf16 step of it (both round an f32 result to bf16 once; the kernel's
    split p v keeps 16 bits of p), and bit-identical when run again."""
    B, H, KV = 2, 8, 2
    rng = np.random.default_rng(S * hd + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(card, torch.bfloat16) for shape in
               ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    n0 = _build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    again = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["flash_attention"] == n0 + 2
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, again)
    ref = flash_attention_ref(q, k, v, window=window)
    assert_close(out.float().cpu(), ref.float().cpu(), 2 ** -7)
    assert_bf16_steps(out, ref)


@pytest.mark.cuda
def test_lm_kernel_wrappers_raise_on_what_the_kernel_does_not_take(card):
    args = [torch.from_numpy(a).to(card) for a in _ssd_case(
        np.random.default_rng(0), 1, 1, 512, 2, 32, 32)]
    with pytest.raises(ValueError, match="chunk 512"):
        ssd_chunk(*args)
    with pytest.raises(TypeError, match="takes"):
        ssd_chunk(*(a[:, :, :64].double() for a in args))
    q = torch.zeros(1, 8, 2, 256, device=card)
    with pytest.raises(ValueError, match="head dim 256"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="takes"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 24, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q, q, q)


def _engine_problem(card):
    """synthetic_small, n=400, K=8 iid, gamma=1e-3, f64, on the card."""
    from repro_torch.core import solve_reference
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    clients = partition(X, y, 8, "iid", seed=0, device=card)
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64, device=card)
    return prob, solve_reference(prob, iters=50)


@pytest.mark.cuda
@pytest.mark.parametrize("channel", [None, "int8"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_engine_graph_equals_the_loop_on_card(card, channel, chunk):
    """The engine's CUDA graph against the per-round loop over 7 rounds
    (the last chunk short): the same metrics, rel-errors, final params and
    comm buffers bit for bit; every kernel of the round counted once per
    slot replayed, the warm-up round apart."""
    from repro_torch.core import (AlgoHParams, init_state, make_chunk_runner,
                                  make_round_fn, run_rounds)
    from repro_torch.core.engine import rel_error
    from repro_torch.utils import tree_math as tm
    prob, w_star = _engine_problem(card)
    rf = make_round_fn("fedosaa_svrg", prob,
                       AlgoHParams(eta=0.5, local_epochs=3), channel,
                       device=card)
    state = init_state(prob, device=card, channel=channel, algo="fedosaa_svrg")
    loss, rel = [], []
    norm = float(tm.tree_norm(w_star))
    for _ in range(7):
        state, m = rf(state)
        loss.append(float(m.loss))
        rel.append(float(rel_error(state.params, w_star, norm, m.loss)))
    runner = make_chunk_runner(rf, chunk, w_star=w_star)
    _build.reset_launches()
    eng, trace = run_rounds(rf, init_state(prob, device=card, channel=channel,
                                           algo="fedosaa_svrg"),
                            7, chunk=chunk, w_star=w_star, runner=runner)
    slots = chunk * -(-7 // chunk)
    assert _build.LAUNCHES["trajectory"] == _build.LAUNCHES["gram"] == slots
    assert _build.LAUNCHES["aa_step"] == slots
    assert _build.LAUNCHES["int8_uplink"] == (2 * slots if channel else 0)
    assert runner.warmup_launches.launches["aa_step"] == 1
    assert trace.loss.tolist() == loss and trace.rel_error.tolist() == rel
    assert eng.t == state.t == 7
    assert torch.equal(eng.params, state.params)
    for tag, bufs in (state.comm or {}).items():
        for name, buf in bufs.items():
            assert torch.equal(eng.comm[tag][name], buf), (tag, name)


@pytest.mark.cuda
def test_engine_refuses_a_round_with_a_host_read(card):
    """aa_impl="tree" reads eigh's info back every round: the capture
    raises with that cause, and nothing runs eagerly in its place."""
    from repro_torch.core import (AlgoHParams, init_state, make_round_fn,
                                  run_rounds)
    prob, _ = _engine_problem(card)
    rf = make_round_fn("fedosaa_svrg", prob,
                       AlgoHParams(eta=0.5, local_epochs=3, aa_impl="tree"),
                       device=card)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        run_rounds(rf, init_state(prob, device=card), 2, chunk=2)
