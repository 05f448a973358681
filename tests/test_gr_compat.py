"""gr_compat.wrap adapter logic, tested against a minimal fake ``gnuradio``
module (GR itself isn't installable in this image — the adapter is what
makes the grc/*.block.yml descriptors instantiate real JAX blocks inside a
stock GNU Radio flowgraph, the role of the reference's pybind bindings,
python/bindings/python_bindings.cc:29-49)."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest


class _FakeBasicBlock:
    def __init__(self, name=None, in_sig=None, out_sig=None):
        self._name = name
        self._in_sig = in_sig
        self._out_sig = out_sig
        self.consumed = []
        self.relative_rate = None
        self.output_multiple = None
        self.registered_ports = []
        self.published = []

    def set_relative_rate(self, r):
        self.relative_rate = r

    def set_output_multiple(self, m):
        self.output_multiple = m

    def message_port_register_out(self, sym):
        self.registered_ports.append(sym)

    def message_port_pub(self, sym, msg):
        self.published.append((sym, msg))

    def consume_each(self, n):
        self.consumed.append(n)


@pytest.fixture()
def fake_gr(monkeypatch):
    gr_mod = types.ModuleType("gnuradio.gr")
    gr_mod.basic_block = _FakeBasicBlock
    gnuradio = types.ModuleType("gnuradio")
    gnuradio.gr = gr_mod
    pmt_mod = types.ModuleType("pmt")
    pmt_mod.intern = lambda s: ("sym", s)
    pmt_mod.to_pmt = lambda x: ("pmt", x)
    monkeypatch.setitem(sys.modules, "gnuradio", gnuradio)
    monkeypatch.setitem(sys.modules, "gnuradio.gr", gr_mod)
    monkeypatch.setitem(sys.modules, "pmt", pmt_mod)
    return gr_mod


def test_wrap_elementwise_roundtrip(fake_gr):
    from clenabled_tpu.blocks import MultiplyConst
    from clenabled_tpu.gr_compat import wrap

    g = wrap(MultiplyConst(2.0 + 0j))
    x = (np.arange(8) + 1j).astype(np.complex64)
    out = np.zeros(8, np.complex64)
    produced = g.general_work([x], [out])
    assert produced == 8
    assert g.consumed == [8]
    np.testing.assert_allclose(out, 2.0 * x, rtol=1e-6)


def test_wrap_quantum_and_decimation(fake_gr):
    """A decimating filter: consumes quantum multiples, produces n/decim,
    sets relative rate + output multiple, and carries state across calls
    (stream continuity at the work-call seam)."""
    from clenabled_tpu.blocks import FIRTapFilter
    from clenabled_tpu.gr_compat import wrap
    from clenabled_tpu.streaming.block import Block

    taps = np.array([0.25, 0.5, 0.25], np.float32)
    blk = FIRTapFilter(2, taps, use_time=True)
    g = wrap(blk)
    assert g.relative_rate == 0.5
    q = blk.quantum
    n = 4 * q
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)

    # two work calls over halves == one call over the whole stream
    out_a = np.zeros(n, np.complex64)
    p1 = g.general_work([x[: n // 2]], [out_a[: n // 4]])
    p2 = g.general_work([x[n // 2:]], [out_a[n // 4:]])
    assert p1 == p2 == n // 4
    assert g.consumed == [n // 2, n // 2]

    g2 = wrap(FIRTapFilter(2, taps, use_time=True))
    out_b = np.zeros(n, np.complex64)
    g2.general_work([x], [out_b[: n // 2]])
    np.testing.assert_allclose(out_a[: n // 2], out_b[: n // 2],
                               rtol=1e-5, atol=1e-6)


def test_wrap_forecast_rounds_to_quantum(fake_gr):
    from clenabled_tpu.blocks import FIRTapFilter
    from clenabled_tpu.gr_compat import wrap

    blk = FIRTapFilter(4, np.ones(5, np.float32), use_time=True)
    g = wrap(blk)
    need = g.forecast(10, 1)
    assert len(need) == 1
    assert need[0] % blk.quantum == 0
    assert need[0] * 1.0 / 4.0 >= 10 or need[0] >= blk.quantum


def test_wrap_partial_input_waits_for_quantum(fake_gr):
    from clenabled_tpu.blocks import FIRTapFilter
    from clenabled_tpu.gr_compat import wrap

    blk = FIRTapFilter(2, np.ones(3, np.float32), use_time=True)
    g = wrap(blk)
    x = np.zeros(blk.quantum - 1, np.complex64)
    out = np.zeros(blk.quantum, np.complex64)
    assert g.general_work([x], [out]) == 0
    assert g.consumed == []


def test_wrap_sink_publishes_messages(fake_gr):
    from clenabled_tpu.blocks import XCorrelate
    from clenabled_tpu.gr_compat import wrap

    blk = XCorrelate(2, signal_length=256, max_search_index=16)
    g = wrap(blk)
    assert ("sym", "corr") in g.registered_ports
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
        np.complex64)
    produced = g.general_work([sig, np.roll(sig, 3)], [])
    assert produced == 0
    assert g.consumed == [256]
    # sinks default to pipeline_depth=2 (round 5): the publish trails the
    # dispatching call by one — flush() (or the stop() callback) drains it
    assert g.published == []
    g.flush()
    (sym, (tag, payload)), = g.published
    assert sym == ("sym", "corr") and tag == "pmt"
    assert int(np.asarray(payload["corrective_lags"]).ravel()[0]) == -3


def test_wrap_planar_block_converts_streams(fake_gr):
    """A planar=True block behind wrap(): complex GR buffers are converted
    to planar.PC on the way in and back to complex on the way out — the
    path planar blocks take inside a GR flowgraph."""
    from clenabled_tpu.blocks import CostasLoop
    from clenabled_tpu.gr_compat import wrap

    blk = CostasLoop(0.1, 2, planar=True)
    g = wrap(blk)
    n = 1024
    t = np.arange(n)
    x = np.exp(1j * (2 * np.pi * 0.01 * t + 0.5)).astype(np.complex64)
    out = np.zeros(n, np.complex64)
    assert g.general_work([x], [out]) == n

    # direct planar drive == wrapped drive
    from clenabled_tpu.dsp import planar
    import jax.numpy as jnp

    blk2 = CostasLoop(0.1, 2, planar=True)
    st = blk2.init_state()
    _, (want_pc,), _ = blk2.apply(
        st, [planar.PC(jnp.asarray(x.real), jnp.asarray(x.imag))])
    want = np.asarray(want_pc.re) + 1j * np.asarray(want_pc.im)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_wrap_source_produces_frames(fake_gr):
    from clenabled_tpu.blocks import SignalSource
    from clenabled_tpu.gr_compat import wrap

    blk = SignalSource(48000.0, 1, 1000.0, 1.0, frame_size=512)
    g = wrap(blk)
    out = np.zeros(512, np.complex64)
    assert g.general_work([], [out]) == 512
    # phase-continuous across calls
    out2 = np.zeros(512, np.complex64)
    g.general_work([], [out2])
    t = np.arange(1024) / 48000.0
    want = np.exp(1j * 2 * np.pi * 1000.0 * t).astype(np.complex64)
    got = np.concatenate([out, out2])
    np.testing.assert_allclose(got.real, want.real, atol=1e-4)


def test_wrap_interpolating_block(fake_gr):
    """An interpolating block (rate > 1) through wrap(): forecast asks for
    fewer inputs than outputs, output_multiple = quantum·rate, and the
    produced count is n·interp."""
    from fractions import Fraction

    import jax.numpy as jnp

    from clenabled_tpu.gr_compat import wrap
    from clenabled_tpu.streaming.block import FunctionBlock

    interp = 4

    def upsample(x):
        out = jnp.zeros((x.shape[-1], interp), x.dtype)
        return out.at[:, 0].set(x).reshape(-1)

    blk = FunctionBlock(upsample, rate=Fraction(interp), quantum=8)
    g = wrap(blk)
    assert g.output_multiple == 8 * interp
    need = g.forecast(64, 1)
    assert need[0] % 8 == 0 and need[0] * interp >= 64
    x = (np.arange(16) + 0j).astype(np.complex64)
    out = np.zeros(16 * interp, np.complex64)
    assert g.general_work([x], [out]) == 16 * interp
    np.testing.assert_allclose(out[::interp], x, rtol=1e-6)
    assert not np.any(out.reshape(-1, interp)[:, 1:])


def test_wrap_float_output_signature_defaults(fake_gr):
    """Round-3 hardening: out_sig derives from the block's out_kinds —
    mag/arg/demod wraps must declare float32 outputs, not complex64, or a
    real GR scheduler silently misinterprets the stream bytes."""
    from clenabled_tpu.blocks import ComplexToMag, MagPhaseToComplex
    from clenabled_tpu.blocks import QuadratureDemod, SNRHelper
    from clenabled_tpu.gr_compat import wrap

    w = wrap(ComplexToMag())
    assert w._out_sig == [np.float32]
    assert w._in_sig == [np.complex64]
    w = wrap(QuadratureDemod(2.0))
    assert w._out_sig == [np.float32]
    w = wrap(MagPhaseToComplex())
    assert w._in_sig == [np.float32, np.float32]
    assert w._out_sig == [np.complex64]
    w = wrap(SNRHelper())
    assert w._in_sig == [np.float32, np.float32]
    assert w._out_sig == [np.float32]
    # explicit signatures still win
    w = wrap(ComplexToMag(), out_sig=[np.float64])
    assert w._out_sig == [np.float64]


def test_wrap_buckets_frames_to_pow2_quanta(fake_gr):
    """Round-3 hardening: GR offers arbitrary buffer sizes; the adapter
    must process power-of-two frame buckets so the jit cache stays
    bounded (log2 sizes, not one entry per distinct scheduler offer)."""
    from clenabled_tpu.blocks import MultiplyConst
    from clenabled_tpu.gr_compat import wrap

    blk = wrap(MultiplyConst(2.0))
    rng = np.random.default_rng(0)
    seen_sizes = set()
    remaining = rng.standard_normal(12000).astype(np.complex64)
    # scheduler-style loop with awkward offer sizes
    for offer in (3000, 1700, 999, 2048, 1213, 1024):
        chunk = remaining[:offer]
        out = np.empty(offer, np.complex64)
        n = blk.general_work([chunk], [out])
        assert n == 0 or (n & (n - 1)) == 0  # power-of-two bucket
        seen_sizes.add(n)
        np.testing.assert_allclose(out[:n], 2.0 * chunk[:n], rtol=1e-6)
        consumed = blk.consumed[-1] if n else 0
        assert consumed == n  # rate-1 block
        remaining = remaining[consumed:]
    # distinct traced sizes bounded by log2, not by #offers
    assert len(seen_sizes - {0}) <= 4


def _drive(blk, x, offer, out_space):
    """Scheduler-sim loop: offer up to ``offer`` input samples and
    ``out_space`` output samples per call until the stream drains."""
    remaining = x
    collected = []
    idle = 0
    while idle < 3:
        chunk = remaining[:offer]
        out = np.zeros(out_space, np.complex64)
        n = blk.general_work([chunk], [out])
        consumed = (blk.consumed[-1] if blk.consumed else 0)
        blk.consumed.clear()
        remaining = remaining[consumed:]
        collected.append(out[:n])
        idle = idle + 1 if (n == 0 and consumed == 0) else 0
    if hasattr(blk, "flush"):
        blk.flush()
        out = np.zeros(out_space, np.complex64)
        n = blk._emit([out])
        collected.append(out[:n])
    return np.concatenate(collected)


def test_wrap_batched_matches_percall_stateful(fake_gr):
    """Round-4 batching: with large scheduler offers the adapter runs K
    frames per lax.scan dispatch; the emitted stream must equal the
    per-call adapter's bit-for-bit for a STATEFUL block (filter tail
    carried across the batch seams), including the flush() tail."""
    from clenabled_tpu.blocks import FIRTapFilter
    from clenabled_tpu.gr_compat import wrap

    taps = np.array([0.25, 0.5, 0.25, 0.125], np.float32)
    q = FIRTapFilter(1, taps, use_time=True).quantum

    rng = np.random.default_rng(4)
    n = 8192 * 12 + 3000          # awkward tail (not a frame multiple)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)

    g_ref = wrap(FIRTapFilter(1, taps, use_time=True), batch_frames=1)
    want = _drive(g_ref, x, offer=1 << 14, out_space=1 << 15)

    g_bat = wrap(FIRTapFilter(1, taps, use_time=True), batch_frames=4)
    got = _drive(g_bat, x, offer=1 << 14, out_space=1 << 15)

    m = min(len(want), len(got))
    assert m >= n - 8192            # batched path may hold < bf at the end
    np.testing.assert_allclose(got[:m], want[:m], rtol=1e-5, atol=1e-6)


def test_wrap_batched_trickle_keeps_percall_path(fake_gr):
    """Small offers (live/throttled streams) must NOT accumulate latency:
    the batched adapter falls back to the per-call path and produces in
    the same call."""
    from clenabled_tpu.blocks import MultiplyConst
    from clenabled_tpu.gr_compat import wrap

    blk = wrap(MultiplyConst(3.0), batch_frames="auto")
    x = (np.arange(256) + 1j).astype(np.complex64)
    out = np.zeros(256, np.complex64)
    n = blk.general_work([x], [out])
    assert n == 256                 # produced immediately, no deferral
    np.testing.assert_allclose(out, 3.0 * x, rtol=1e-6)


def test_wrap_batched_source_stays_phase_continuous(fake_gr):
    from clenabled_tpu.blocks import SignalSource
    from clenabled_tpu.gr_compat import wrap

    blk = SignalSource(48000.0, 1, 1000.0, 1.0, frame_size=512)
    g = wrap(blk, batch_frames=4)
    got = []
    for _ in range(6):
        out = np.zeros(512, np.complex64)
        n = g.general_work([], [out])
        got.append(out[:n])
    got = np.concatenate(got)
    t = np.arange(len(got)) / 48000.0
    want = np.exp(1j * 2 * np.pi * 1000.0 * t).astype(np.complex64)
    np.testing.assert_allclose(got.real, want.real, atol=1e-4)


def test_wrap_batched_sink_publishes_per_frame(fake_gr):
    """A sink under batching publishes one message per frame, in stream
    order, once a group dispatches."""
    from fractions import Fraction

    import jax.numpy as jnp

    from clenabled_tpu.gr_compat import wrap
    from clenabled_tpu.streaming.block import Block

    class MeanSink(Block):
        n_inputs, n_outputs = 1, 0
        msg_ports = ("mean",)

        def __init__(self):
            super().__init__()
            self.quantum = 1024
            self.rate = Fraction(1)

        def init_state(self):
            return ()

        def apply(self, state, ins):
            return state, [], {"mean": jnp.mean(jnp.abs(ins[0]))}

    g = wrap(MeanSink(), batch_frames=2)
    bf = 8192                       # quantum 1024 → bucket 8192
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3, 4)])
    for i in range(4):
        g.general_work([x[i * bf:(i + 1) * bf]], [])
    means = [float(np.asarray(m[1][1])) for m in g.published]
    assert means == [1.0, 2.0, 3.0, 4.0]


def test_wrap_bucketing_respects_decimator_output_capacity(fake_gr):
    """pow2 bucketing + decimation: the bucket must still fit the output
    buffer GR offers, and consumed/produced counts stay consistent."""
    from clenabled_tpu.blocks import LowPassFilter
    from clenabled_tpu.gr_compat import wrap

    lpf = LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
    blk = wrap(lpf)
    q = lpf.quantum
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(q * 7) + 1j * rng.standard_normal(q * 7)
         ).astype(np.complex64)
    # output space for only one quantum's worth of decimated samples
    out = np.empty(q // 2, np.complex64)
    n = blk.general_work([x], [out])
    assert n == q // 2          # bucket clamped by output capacity
    assert blk.consumed[-1] == q
    # plenty of room: bucket = largest pow2 multiple of quantum (4q of 7q)
    out2 = np.empty(q * 4, np.complex64)
    n2 = blk.general_work([x], [out2])
    assert n2 == 2 * q          # 4q in → 2q out


def test_wrap_batched_decimator_matches_percall(fake_gr):
    """Batched adapter + rate != 1: the drain queue must emit the
    decimated stream identically to the per-call adapter."""
    from clenabled_tpu.blocks import LowPassFilter
    from clenabled_tpu.gr_compat import wrap

    def mk():
        return LowPassFilter(4, 1.0, 1e6, 100e3, 50e3)

    q = mk().quantum
    rng = np.random.default_rng(6)
    n = max(1 << 16, q * 64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    want = _drive(wrap(mk(), batch_frames=1), x, offer=1 << 14,
                  out_space=1 << 14)
    got = _drive(wrap(mk(), batch_frames=3), x, offer=1 << 14,
                 out_space=1 << 14)
    m = min(len(want), len(got))
    assert m > 0
    np.testing.assert_allclose(got[:m], want[:m], rtol=1e-5, atol=1e-6)


def test_wrap_stop_drains_pending_batch_frames(fake_gr):
    """The GR scheduler's stop() callback must drain
    consumed-but-unprocessed batch frames so their messages publish even
    when the flowgraph terminates before a full K-frame group forms."""
    from fractions import Fraction

    import jax.numpy as jnp

    from clenabled_tpu.gr_compat import wrap
    from clenabled_tpu.streaming.block import Block

    class MeanSink(Block):
        n_inputs, n_outputs = 1, 0
        msg_ports = ("mean",)

        def __init__(self):
            super().__init__()
            self.quantum = 1024
            self.rate = Fraction(1)

        def init_state(self):
            return ()

        def apply(self, state, ins):
            return state, [], {"mean": jnp.mean(jnp.abs(ins[0]))}

    g = wrap(MeanSink(), batch_frames=4)
    bf = 8192                       # quantum 1024 → batch frame 8192
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3)])
    for i in range(3):              # 3 frames pend, group of 4 never forms
        g.general_work([x[i * bf:(i + 1) * bf]], [])
    assert g.published == []
    assert g.stop() is True         # scheduler teardown → flush
    means = [float(np.asarray(m[1][1])) for m in g.published]
    assert means == [1.0, 2.0, 3.0]


def _mean_sink_cls():
    from fractions import Fraction

    import jax.numpy as jnp

    from clenabled_tpu.streaming.block import Block

    class MeanSink(Block):
        n_inputs, n_outputs = 1, 0
        msg_ports = ("mean",)

        def __init__(self):
            super().__init__()
            self.quantum = 1024
            self.rate = Fraction(1)

        def init_state(self):
            return ()

        def apply(self, state, ins):
            return state, [], {"mean": jnp.mean(jnp.abs(ins[0]))}

    return MeanSink


def test_wrap_sink_pipelines_percall_dispatch(fake_gr):
    """Round 5: sink blocks default to pipeline_depth=2 — the host fetch
    of frame N-1's message overlaps frame N's device compute (the
    reference's async worker semantics: publishes trail by one call and
    flush()/stop() drain the tail)."""
    from clenabled_tpu.gr_compat import wrap

    g = wrap(_mean_sink_cls()(), batch_frames=1)
    bf = 1024
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3)])
    assert g.general_work([x[:bf]], []) == 0
    assert g.published == []                      # 1 frame in flight
    g.general_work([x[bf:2 * bf]], [])
    assert len(g.published) == 1                  # frame 0 landed
    g.general_work([x[2 * bf:]], [])
    g.flush()
    means = [float(np.asarray(m[1][1])) for m in g.published]
    assert means == [1.0, 2.0, 3.0]
    assert g.consumed == [bf, bf, bf]


def test_wrap_stream_pipeline_depth_opt_in(fake_gr):
    """A stream block with explicit pipeline_depth=2: outputs trail one
    work call through the output queue; the drained stream equals the
    unpipelined one."""
    from clenabled_tpu.blocks import MultiplyConst
    from clenabled_tpu.gr_compat import wrap

    g = wrap(MultiplyConst(2.0 + 0j), batch_frames=1, pipeline_depth=2)
    x = (np.arange(16) + 1j).astype(np.complex64)
    out = np.zeros(16, np.complex64)
    p1 = g.general_work([x[:8]], [out[:8]])
    assert p1 == 0                                # frame 0 in flight
    p2 = g.general_work([x[8:]], [out[:8]])       # frame 0 emits now
    assert p2 == 8
    np.testing.assert_allclose(out[:8], 2.0 * x[:8], rtol=1e-6)
    # the trailing in-flight frame drains through a normal work call with
    # no fresh input (the scheduler's wind-down offers) — public API only
    p3 = g.general_work([x[:0]], [out[8:]])
    assert p3 == 8
    np.testing.assert_allclose(out[8:], 2.0 * x[8:], rtol=1e-6)


def test_wrap_batched_stateless_vmaps_and_matches(fake_gr):
    """Round 5: a stateless block's K-frame batch dispatch vmaps (frames
    independent) and the emitted stream equals per-call processing."""
    from clenabled_tpu.blocks import MultiplyConst
    from clenabled_tpu.gr_compat import wrap

    x = (np.arange(4 << 13) + 1j).astype(np.complex64)
    g_ref = wrap(MultiplyConst(2.0 + 0j), batch_frames=1)
    g_bat = wrap(MultiplyConst(2.0 + 0j), batch_frames=4)
    assert MultiplyConst(1.0).stateless

    def drive(g):
        out = np.zeros_like(x)
        done = 0
        pos = 0
        offer = 1 << 13
        while pos < len(x) or done < len(x):
            hi = min(len(x), pos + offer)
            produced = g.general_work([x[pos:hi]],
                                      [out[done:done + offer]])
            consumed = sum(g.consumed)
            g.consumed.clear()
            # track absolute consumption via return bookkeeping
            pos += consumed
            done += produced
            if pos >= len(x) and produced == 0:
                g.flush()
                produced = g._emit([out[done:]])
                done += produced
                if produced == 0:
                    break
        return out[:done]

    a = drive(g_ref)
    b = drive(g_bat)
    n = min(len(a), len(b))
    assert n >= len(x) // 2
    np.testing.assert_allclose(a[:n], b[:n], rtol=1e-6)
