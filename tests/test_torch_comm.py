"""The port's wire (repro_torch.comm and its use in core/) against the JAX
package's repro.comm: codecs, channels, uplink schemas, comm state and byte
accounting, from the same inputs.

Codec roundtrips are compared bit for bit: identity, fp32 and bf16 are
casts (bf16 rounds to nearest-even on both sides); int8 is fed the
reference's own uniforms and the reference runs op by op (jax.disable_jit:
compiled, XLA turns its amax / 127 into amax * fl(1/127); see
tests/test_torch_quant.py); topk is given data without ties, since between
equal magnitudes torch.topk and jax.lax.top_k may keep other indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_channel as jax_make_channel
from repro.comm import parse_codec as jax_parse_codec
from repro.comm.schema import CTRL_UPLINK as J_CTRL
from repro.comm.schema import DELTA_UPLINK as J_DELTA
from repro.comm.schema import DIR_UPLINK as J_DIR
from repro.comm.schema import GRAD_UPLINK as J_GRAD
from repro.comm.schema import uplink_byte_breakdown as jax_breakdown
from repro.core import comm_bytes_per_round as jax_comm_bytes
from repro.core import init_state as jax_init_state
from repro.core.algorithms import init_comm_state as jax_init_comm
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.comm import (CTRL_UPLINK, DELTA_UPLINK, DIR_UPLINK,
                              GRAD_UPLINK, Int8SRCodec, TopKCodec,
                              make_channel, parse_codec, uplink_byte_breakdown)
from repro_torch.comm.codecs import Codec
from repro_torch.core import (ALGORITHMS, AlgoHParams, CrossClientReduce,
                              comm_bytes_per_round, init_comm_state, init_state,
                              run_federated, solve_reference)
from repro_torch.core import convert
from repro_torch.data import make_binary_classification, partition
from repro_torch.kernels.quant import int8_sr_uplink, int8_sr_uplink_ref
from repro_torch.models.logreg import make_logreg_problem

SPECS = ["identity", "fp32", "bf16", "int8", "int8:64", "int8+noef",
         "fp32+ef", "bf16+ef", "topk:0.05", "topk", "topk:0.05+noef",
         "bf16/bf16", "int8/fp32", "int8+ef/bf16", "identity/fp32"]
UPLINK_PAIRS = [(GRAD_UPLINK, J_GRAD), (DELTA_UPLINK, J_DELTA),
                (CTRL_UPLINK, J_CTRL), (DIR_UPLINK, J_DIR)]


def _x64(fn):
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", was)


def _client_keys(rng, K, fold):
    """The per-client int8 keys of uplink ``fold`` in the round starting
    from ``rng`` (repro/core/algorithms.py:1209-1210, :873; codecs.py:80)."""
    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    return [jax.random.fold_in(jax.random.fold_in(keys[k], fold), 0)
            for k in range(K)]


class TestCodecs:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("spec", ["identity", "fp32", "bf16", "int8",
                                      "int8:64", "topk:0.05", "topk:0.3"])
    def test_roundtrip_and_bytes_match_reference(self, spec, dtype):
        """Every client's roundtrip of a [K, n] stack against the
        reference codec on each row; wire_bytes for several shapes."""
        K, n = 5, 300
        rng = np.random.default_rng(len(spec))
        x = (rng.standard_normal((K, n)) * 10.0 ** rng.integers(-3, 3, (K, 1))
             ).astype(dtype)
        ours, ref = parse_codec(spec), jax_parse_codec(spec)
        assert str(ours) == str(ref)
        assert (ours.deterministic, ours.lossy, ours.delta_only) == (
            ref.deterministic, ref.lossy, ref.delta_only)
        keys = _client_keys(jax.random.PRNGKey(3), K, 102)
        u = None
        if not ours.deterministic:
            nc, C = ours.draw_shape(n)
            u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                k, (nc, C), jnp.float32)) for k in keys]))

        def reference():
            with jax.disable_jit():
                return np.stack([np.asarray(ref.roundtrip(
                    jnp.asarray(x[k]), keys[k])) for k in range(K)])

        want = _x64(reference)
        got = ours.roundtrip(torch.from_numpy(x), u).numpy()
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
        for shape in [(54,), (1000,), (3, 7), (257,)]:
            for tdt, jdt in [(torch.float32, jnp.float32),
                             (torch.float64, np.float64)]:
                assert ours.wire_bytes(shape, tdt) == ref.wire_bytes(shape, jdt)

    def test_wire_bytes_at_the_slice_shape(self):
        """d=54: int8 54 B + one 4 B scale; identity charges the compute
        dtype (8 B/value in f64); topk:0.05 keeps 3 (value, index) pairs."""
        p64 = torch.zeros(54, dtype=torch.float64)
        assert parse_codec("int8").tree_bytes(p64) == 58
        assert parse_codec("identity").tree_bytes(p64) == 432
        assert parse_codec("fp32").tree_bytes(p64) == 216
        assert parse_codec("bf16").tree_bytes(p64) == 108
        assert parse_codec("topk:0.05").tree_bytes(p64) == 24

    @pytest.mark.parametrize("n", [31, 256, 1000])
    def test_int8_error_bounded_by_chunk_scale(self, n):
        """The reference's contract (tests/test_comm.py::TestCodecs): every
        error stays under its chunk's scale max|x_chunk|/127."""
        gen = torch.Generator().manual_seed(n)
        x = torch.randn(3, n, generator=gen)
        codec = Int8SRCodec(chunk=64)
        u = torch.rand((3, *codec.draw_shape(n)), generator=gen)
        err = (codec.roundtrip(x, u) - x).abs()
        for c0 in range(0, n, 64):
            scale = x[:, c0:c0 + 64].abs().amax(-1) / 127.0
            assert (err[:, c0:c0 + 64].amax(-1) <= scale + 1e-7).all()

    @pytest.mark.parametrize("chunk,scale_exp", [(64, -6), (128, 0), (256, 6)])
    def test_int8_unbiased_over_many_draws(self, chunk, scale_exp):
        """E[roundtrip(x)] = x: over 400 draws (400 clients of one call)
        the mean is within 5 Monte-Carlo sigmas (sigma < scale/sqrt(400))."""
        rng = np.random.default_rng(chunk)
        n, draws = 777, 400
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * np.float32(10.0 ** scale_exp))
        codec = Int8SRCodec(chunk=chunk)
        u = torch.rand((draws, *codec.draw_shape(n)),
                       generator=torch.Generator().manual_seed(chunk))
        mean = codec.roundtrip(x.expand(draws, n), u).mean(0)
        scale = float(x.abs().max()) / 127.0
        assert float((mean - x).abs().max()) < 5 * scale / np.sqrt(draws)

    def test_int8_needs_uniforms_and_topk_checks_ratio(self):
        with pytest.raises(ValueError, match="uniforms"):
            Int8SRCodec().roundtrip(torch.zeros(2, 10))
        with pytest.raises(ValueError, match="ratio"):
            TopKCodec(ratio=0.0)
        with pytest.raises(ValueError, match="unknown codec"):
            parse_codec("fp8")


class TestChannel:
    @pytest.mark.parametrize("spec", SPECS)
    def test_make_channel_matches_reference(self, spec):
        ours, ref = make_channel(spec), jax_make_channel(spec)
        assert ours.name == ref.name
        assert ours.error_feedback == ref.error_feedback
        assert ours.is_identity == ref.is_identity
        assert (str(ours.up), str(ours.down)) == (str(ref.up), str(ref.down))
        p = torch.zeros(54, dtype=torch.float64)
        jp = np.zeros(54, np.float64)
        for kind in ("delta", "aux"):
            assert str(ours.up_codec(kind)) == str(ref.up_codec(kind))
            assert ours.uplink_bytes(p, kind) == _x64(
                lambda: ref.uplink_bytes(jnp.asarray(jp), kind))
        assert ours.downlink_bytes(p) == _x64(
            lambda: ref.downlink_bytes(jnp.asarray(jp)))
        for s, js in UPLINK_PAIRS:
            assert tuple(s) == tuple(js)
            assert ours.state_buffers(s) == ref.state_buffers(js), s.tag

    @pytest.mark.parametrize("spec,match", [("fp32/int8", "stochastic"),
                                            ("int8/topk:0.1", "delta-only")])
    def test_downlink_refusals(self, spec, match):
        with pytest.raises(ValueError, match=match):
            jax_make_channel(spec)
        with pytest.raises(ValueError, match=match):
            make_channel(spec)

    def test_broadcast_is_the_downlink_codec(self):
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(54))
        assert CrossClientReduce(make_channel("int8")).broadcast(x) is x
        out = CrossClientReduce(make_channel("int8/bf16")).broadcast(x)
        assert torch.equal(out, x.to(torch.bfloat16).to(torch.float64))

    def test_uplink_checks_its_anchor(self):
        R = CrossClientReduce(make_channel("int8"))
        with pytest.raises(ValueError, match="anchor missing"):
            R.uplink(torch.zeros(2, 5), DELTA_UPLINK)
        with pytest.raises(ValueError, match="anchor given"):
            R.uplink(torch.zeros(2, 5), GRAD_UPLINK, anchor=torch.zeros(5))


def _uplink_buffers(rng, K, n, dtype, anchor, ref, ef):
    """x [K, n] of mixed magnitudes and the optional anchor [n], ref and ef
    [K, n]; client 0's upload is all zeros (v = 0: x = anchor, ref = ef =
    0 in its row)."""
    x = (rng.standard_normal((K, n)) * 10.0 ** rng.integers(-3, 3, (K, 1))
         ).astype(dtype)
    a = rng.standard_normal(n).astype(dtype) if anchor else None
    r = (0.1 * rng.standard_normal((K, n))).astype(dtype) if ref else None
    e = (1e-3 * rng.standard_normal((K, n))).astype(dtype) if ef else None
    x[0] = a if anchor else 0.0
    for buf in (r, e):
        if buf is not None:
            buf[0] = 0.0
    return [None if t is None else torch.from_numpy(t) for t in (x, a, r, e)]


class TestUplink:
    """The uplink's arithmetic (anchor, difference coding, error feedback)
    around the codec: the int8 codec's one-launch ``uplink`` against the
    base class's glue around its two-launch ``roundtrip``."""

    @pytest.mark.parametrize("n", [54, 300, 256 * 3])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("anchor,ref,ef", [
        (a, r, e) for a in (False, True) for r in (False, True)
        for e in (False, True)])
    def test_int8_uplink_is_the_codec_glue(self, anchor, ref, ef, dtype, n):
        """int8_sr_uplink_ref (and Int8SRCodec.uplink, on the CPU its plain
        version) equals Codec.uplink around Int8SRCodec.roundtrip bit for
        bit, for every set of buffers; the all-zero client decodes to
        exactly ref + anchor with a zero residual."""
        K = 5
        x, a, r, e = _uplink_buffers(np.random.default_rng(n), K, n, dtype,
                                     anchor, ref, ef)
        codec = Int8SRCodec()
        u = torch.rand((K, *codec.draw_shape(n)),
                       generator=torch.Generator().manual_seed(n))
        want = Codec.uplink(codec, x, u, a, r, e)
        for got in (int8_sr_uplink_ref(x, u, a, r, e),
                    codec.uplink(x, u, a, r, e)):
            for w, g in zip(want, got):
                assert (w is None) == (g is None)
                if w is not None:
                    assert g.dtype == x.dtype and torch.equal(g, w)
        dec, new_e, new_h = want
        assert (new_e is None) == (not ef) and (new_h is None) == (not ref)
        base = torch.zeros(n, dtype=x.dtype)
        if ref:
            base = base + r[0]
            assert torch.equal(new_h[0], base)
        if anchor:
            base = base + a
        assert torch.equal(dec[0], base)
        if ef:
            assert not new_e[0].any()

    @pytest.mark.parametrize("spec", [GRAD_UPLINK, DELTA_UPLINK])
    @pytest.mark.parametrize("channel", ["int8", "int8:64", "int8+noef",
                                         "bf16+ef", "topk:0.05"])
    def test_cross_client_uplink_as_before(self, spec, channel):
        """CrossClientReduce.uplink's server view and comm state equal the
        uplink arithmetic it ran inline before ``Codec.uplink`` (v = stacked
        − anchor − ref + ef, the roundtrip, new_e = v − dec, dec + ref,
        dec + anchor), bit for bit; other tags pass through."""
        K, n = 4, 54
        ch = make_channel(channel)
        rng = np.random.default_rng(len(channel))
        stacked = torch.from_numpy(rng.standard_normal((K, n)))
        anchor = torch.from_numpy(rng.standard_normal(n)) if spec.anchored else None
        sub = {b: torch.from_numpy(0.1 * rng.standard_normal((K, n)))
               for b in ch.state_buffers(spec)}
        other = {"ef": torch.ones(K, n, dtype=torch.float64)}
        state = {spec.tag: sub, "other": other} if sub else None
        codec = ch.up_codec(spec.kind)
        shape = codec.draw_shape(n)
        u = None if shape is None else torch.rand(
            (K, *shape), generator=torch.Generator().manual_seed(n))
        drawn = []

        def draw(s, shp):
            drawn.append((s.tag, shp))
            return u

        dec, new_state = CrossClientReduce(ch).uplink(
            stacked, spec, anchor=anchor, state=state, draw=draw)

        ef, ref = sub.get("ef"), sub.get("ref")
        v = stacked - anchor if anchor is not None else stacked
        if ref is not None:
            v = v - ref
        if ef is not None:
            v = v + ef
        want = codec.roundtrip(v, u)
        new_e = v - want if ef is not None else None
        if ref is not None:
            want = want + ref
        new_h = want if ref is not None else None
        if anchor is not None:
            want = want + anchor
        assert torch.equal(dec, want)
        assert drawn == ([] if shape is None else [(spec.tag, (K, *shape))])
        if not sub:
            assert new_state is state
            return
        assert sorted(new_state) == [spec.tag, "other"]
        assert new_state["other"] is other
        assert sorted(new_state[spec.tag]) == sorted(sub)
        if ef is not None:
            assert torch.equal(new_state[spec.tag]["ef"], new_e)
        if ref is not None:
            assert torch.equal(new_state[spec.tag]["ref"], new_h)

    def test_int8_uplink_checks_its_inputs(self):
        x, u = torch.zeros(2, 300), torch.zeros(2, 2, 256)
        with pytest.raises(ValueError, match="does not cover"):
            int8_sr_uplink(x, torch.zeros(2, 1, 256))
        with pytest.raises(ValueError, match="anchor"):
            int8_sr_uplink(x, u, anchor=torch.zeros(2, 300))
        with pytest.raises(ValueError, match="ref"):
            int8_sr_uplink(x, u, ref=torch.zeros(300))
        with pytest.raises(TypeError, match="ef is torch.float64"):
            int8_sr_uplink(x, u, ef=torch.zeros(2, 300, dtype=torch.float64))
        with pytest.raises(ValueError, match="uniforms"):
            Int8SRCodec().uplink(x)


def _both_problems(n=200, K=4):
    X, y = jax_make("covtype", n=n, seed=0)
    jc = jax_partition(X, y, K, "iid", seed=0)
    pc = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight, device="cpu")
    return jc, make_logreg_problem(pc, 1e-3, dtype=torch.float64, device="cpu")


class TestCommState:
    @pytest.mark.parametrize("algo", ALGORITHMS)
    @pytest.mark.parametrize("spec", SPECS)
    def test_state_and_bytes_match_reference(self, algo, spec):
        ch, jch = make_channel(spec), jax_make_channel(spec)
        p = torch.zeros(54, dtype=torch.float64)

        def reference():
            jp = jnp.zeros(54, jnp.float64)
            return (jax_init_comm(jch, jp, 7, algo), jax_comm_bytes(algo, jp, jch),
                    jax_breakdown(jch, (J_GRAD, J_DELTA), jp))

        ref_state, ref_bytes, ref_breakdown = _x64(reference)
        state = init_comm_state(ch, p, 7, algo)
        assert comm_bytes_per_round(algo, p, spec) == ref_bytes
        assert uplink_byte_breakdown(ch, (GRAD_UPLINK, DELTA_UPLINK),
                                     p) == ref_breakdown
        if ref_state is None:
            assert state is None
            return
        assert sorted(state) == sorted(ref_state)
        for tag, bufs in ref_state.items():
            assert sorted(state[tag]) == sorted(bufs)
            for name, a in bufs.items():
                assert state[tag][name].shape == a.shape == (7, 54)
                assert state[tag][name].dtype == torch.float64
                assert not state[tag][name].any()

    def test_bytes_per_round_of_the_compression_benchmark(self):
        """d=54, f64: the per-round bytes behind ext_compression.json's rows
        (int8 2204 B / 19 rounds, bf16 3672 / 17, fp32 8640 / 20, topk:0.05
        73872 / 162)."""
        p = torch.zeros(54, dtype=torch.float64)
        per_round = {s: comm_bytes_per_round("fedosaa_svrg", p, s)
                     for s in ("int8", "bf16", "fp32", "topk:0.05")}
        assert per_round == {"int8": 116.0, "bf16": 216.0, "fp32": 432.0,
                             "topk:0.05": 456.0}
        assert (2204 / 19, 3672 / 17, 8640 / 20, 73872 / 162) == (
            116.0, 216.0, 432.0, 456.0)
        assert comm_bytes_per_round("fedsvrg", p) == 864.0

    def test_init_state_matches_reference(self):
        """The reference's init_state(..., channel="int8",
        algo="fedosaa_svrg") and the port's carry the same tags, buffers
        and shapes; convert carries the reference's comm state across."""
        jc, pp = _both_problems()

        def reference():
            jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
            return jax_init_state(jp, jax.random.PRNGKey(0), None, "int8",
                                  "fedosaa_svrg")

        ref = _x64(reference)
        ours = init_state(pp, device="cpu", channel="int8", algo="fedosaa_svrg")
        assert ours.t == 0
        assert {t: sorted(b) for t, b in ours.comm.items()} == {
            t: sorted(b) for t, b in ref.comm.items()} == {
            "grad": ["ef", "ref"], "delta": ["ef"]}
        for tag, bufs in ref.comm.items():
            for name, a in bufs.items():
                assert tuple(ours.comm[tag][name].shape) == a.shape == (4, 54)
        rng = np.random.default_rng(1)
        comm = {t: {n: rng.standard_normal(a.shape) for n, a in b.items()}
                for t, b in ref.comm.items()}
        conv = convert.server_state(np.asarray(ref.params), ref.t, comm,
                                    device="cpu")
        for tag, bufs in comm.items():
            for name, a in bufs.items():
                np.testing.assert_array_equal(conv.comm[tag][name].numpy(), a)
        assert convert.server_state(np.zeros(3), 2, None, device="cpu").comm is None
        with pytest.raises(ValueError, match="are \\[K, d\\]"):
            convert.comm_state({"grad": {"ef": np.zeros((2, 3, 4))}}, "cpu")
        assert init_state(pp, device="cpu").comm is None
        with pytest.raises(ValueError, match="pass algo"):
            init_state(pp, device="cpu", channel="int8")


@pytest.fixture(scope="module")
def compression_problem():
    """The reference's ext_compression config: synthetic covtype
    n=20,000, K=20 iid, gamma=1e-3, f64."""
    X, y = make_binary_classification("covtype", n=20_000, seed=0)
    clients = partition(X, y, 20, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64, device="cpu")
    return prob, solve_reference(prob, iters=100)


#: the JAX reference's final loss of int8 FedOSAA-SVRG on the
#: ext_compression config (benchmarks/results/ext_compression.json)
COMPRESSION_LOSS = 0.3128270332955105


@pytest.mark.parametrize("spec,per_round", [("int8", 116.0), ("bf16", 216.0),
                                            ("fp32", 432.0)])
def test_compression_config_reaches_target(compression_problem, spec, per_round):
    """eta=1, L=10, to rel-error 1e-6 within 26 rounds (the reference: int8
    19, bf16 17, fp32 20; its own gate allows int8 1.3x fp32's 20), bytes
    exactly per_round x rounds, final loss within rel 1e-10 of the
    reference's."""
    prob, w_star = compression_problem
    h = run_federated(prob, "fedosaa_svrg", AlgoHParams(eta=1.0, local_epochs=10),
                      40, w_star=w_star, stop_rel_error=1e-6, device="cpu",
                      channel=spec)
    assert h.channel == make_channel(spec).name
    assert h.rel_error[-1] < 1e-6 and len(h.rounds) <= 26, h.rel_error
    np.testing.assert_array_equal(h.comm_bytes,
                                  per_round * np.arange(1, len(h.rounds) + 1))
    assert abs(h.loss[-1] - COMPRESSION_LOSS) <= 1e-10 * COMPRESSION_LOSS


def test_int8_draws_follow_the_seed(compression_problem):
    """The uniforms come from (seed, t, fold): one seed repeats a run bit
    for bit, another seed gives another trajectory."""
    prob, w_star = compression_problem
    hp = AlgoHParams(eta=1.0, local_epochs=10)
    runs = [run_federated(prob, "fedosaa_svrg", hp, 3, w_star=w_star,
                          device="cpu", channel="int8", seed=s)
            for s in (0, 0, 1)]
    assert torch.equal(runs[0].final_params, runs[1].final_params)
    assert not torch.equal(runs[0].final_params, runs[2].final_params)
