"""steps_per_dispatch: K frames per device call via a device-side
lax.scan over the step closure (the block API must not pay one dispatch
per frame at the reference's default 8192-sample frames).  Per-frame semantics must be EXACT: states thread through the
scan identically to K separate step() calls."""

import numpy as np
import pytest

from clenabled_tpu import blocks
from clenabled_tpu.streaming import Flowgraph


def _lpf_mag_graph():
    g = Flowgraph()
    lpf = blocks.LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
    mag = blocks.ComplexToMag()
    feed = g.external_input(lpf)
    g.connect(lpf, mag)
    tap = g.tap(mag, name="m")
    return g, lpf, tap


def test_scan_matches_per_frame_stepping():
    """K=4 scanned dispatch == 4 sequential step() calls, bit-exact
    (same jitted single-frame closure, same state threading)."""
    rng = np.random.default_rng(1)
    g1, lpf1, tap1 = _lpf_mag_graph()
    frame = lpf1.quantum * 2
    r1 = g1.compile(frame_size=frame)
    g2, lpf2, tap2 = _lpf_mag_graph()
    r2 = g2.compile(frame_size=frame, steps_per_dispatch=4)

    x = (rng.standard_normal(8 * frame)
         + 1j * rng.standard_normal(8 * frame)).astype(np.complex64)
    seq = np.concatenate([
        np.asarray(r1.step(x[i * frame:(i + 1) * frame])[tap1])
        for i in range(8)])
    stacked = x.reshape(8, frame)
    got = np.concatenate([
        np.asarray(r2.step(stacked[:4])[tap2]).reshape(-1),
        np.asarray(r2.step(stacked[4:])[tap2]).reshape(-1)])
    np.testing.assert_array_equal(got, seq)
    # carried state also identical
    import jax

    for a, b in zip(jax.tree.leaves(r1.states), jax.tree.leaves(r2.states)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_source_only_graph_scans_without_feeds():
    """0-external-feed graphs scan with an explicit length: the signal
    source's carried phase advances across the K sub-steps."""
    fs, f0, n = 1e6, 125e3, 4096
    g1 = Flowgraph()
    s1 = blocks.SignalSource(fs, 1, f0, 1.0, n)
    t1 = g1.tap(s1, name="o")
    r1 = g1.compile()
    seq = np.concatenate([np.asarray(r1.step()[t1]) for _ in range(3)])

    g2 = Flowgraph()
    s2 = blocks.SignalSource(fs, 1, f0, 1.0, n)
    t2 = g2.tap(s2, name="o")
    r2 = g2.compile(steps_per_dispatch=3)
    got = np.asarray(r2.step()[t2]).reshape(-1)
    np.testing.assert_array_equal(got, seq)


def test_run_batches_and_handles_remainder():
    """run() with a per-frame iterator: stacks K frames per dispatch and
    pushes a sub-K remainder through the single-frame fallback — every
    frame processed, stream state continuous."""
    rng = np.random.default_rng(2)
    g1, lpf1, tap1 = _lpf_mag_graph()
    frame = lpf1.quantum * 2
    r1 = g1.compile(frame_size=frame)
    g2, lpf2, tap2 = _lpf_mag_graph()
    r2 = g2.compile(frame_size=frame, steps_per_dispatch=4)

    nf = 7  # 1 full group of 4 + remainder of 3
    x = (rng.standard_normal(nf * frame)
         + 1j * rng.standard_normal(nf * frame)).astype(np.complex64)
    feeds = [(x[i * frame:(i + 1) * frame],) for i in range(nf)]
    seq = np.concatenate([np.asarray(r1.step(*f)[tap1]) for f in feeds])
    outs = r2.run(iter(feeds))
    got = np.concatenate([np.asarray(o[tap2]).reshape(-1) for o in outs])
    np.testing.assert_array_equal(got, seq)
    assert r2.stats["steps"] == nf
    assert r2.stats["samples"] == nf * frame


def test_messages_dispatch_per_substep():
    """Message handlers keep per-frame semantics under K>1: one callback
    per sub-step, values matching the per-frame run."""
    fs, n = 1e6, 4096

    def build(k):
        g = Flowgraph()
        src = blocks.SignalSource(fs, 1, 125e3, 1.0, n)
        snr = blocks.XCorrelateFFTVCF if False else None
        # use the correlator block's PDU? simpler: SNR-free — use Costas
        # lock port is planar-only; instead use a FunctionBlock emitting a
        # per-frame scalar message.
        from clenabled_tpu.streaming.block import Block

        class Meter(Block):
            n_inputs, n_outputs = 1, 1

            def apply(self, state, ins):
                x = ins[0]
                return state, (x,), {"power": (abs(x) ** 2).mean()}

        m = Meter()
        g.connect(src, m)
        tap = g.tap(m, name="o")
        return g.compile(steps_per_dispatch=k), tap

    r1, t1 = build(1)
    got1 = []
    r1._msg_handlers.setdefault("Meter.power", []).append(
        lambda v: got1.append(float(v)))
    for _ in range(3):
        r1.step()

    r3, t3 = build(3)
    got3 = []
    r3._msg_handlers.setdefault("Meter.power", []).append(
        lambda v: got3.append(float(v)))
    r3.step()
    assert len(got3) == 3
    np.testing.assert_allclose(got3, got1, rtol=1e-6)


def test_stacked_feed_shape_validated():
    g, lpf, tap = _lpf_mag_graph()
    frame = lpf.quantum * 2
    r = g.compile(frame_size=frame, steps_per_dispatch=4)
    bad = np.zeros((2, frame), np.complex64)  # K mismatch
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        r.step(bad)


def test_auto_steps_per_dispatch():
    g, lpf, tap = _lpf_mag_graph()
    frame = lpf.quantum * 2  # small frame -> large K, clamped at 64
    r = g.compile(frame_size=frame, steps_per_dispatch="auto")
    assert r.steps_per_dispatch == min(64, (1 << 21) // frame)
    g2, lpf2, tap2 = _lpf_mag_graph()
    big = lpf2.quantum * (1 << 15)   # > 2^21 samples -> K clamps to 1
    r2 = g2.compile(frame_size=big, steps_per_dispatch="auto")
    assert r2.steps_per_dispatch == 1


def test_scan_with_multirate_graph_and_messages():
    """K>1 over a decimating multi-block chain with a message-emitting
    block: outputs, carried state and per-substep messages all match
    per-frame stepping bit-for-bit."""
    from clenabled_tpu.streaming.block import Block

    class Meter(Block):
        n_inputs, n_outputs = 1, 1

        def apply(self, state, ins):
            x = ins[0]
            return state, (x,), {"peak": abs(x).max()}

    def build(k):
        g = Flowgraph()
        lpf = blocks.LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
        mag = blocks.ComplexToMag()
        m = Meter()
        g.external_input(lpf)
        g.connect(lpf, mag)
        g.connect(mag, m)
        tap = g.tap(m, name="o")
        r = g.compile(frame_size=lpf.quantum * 4, steps_per_dispatch=k)
        return r, tap, lpf.quantum * 4

    rng = np.random.default_rng(9)
    r1, t1, frame = build(1)
    r6, t6, _ = build(6)
    x = (rng.standard_normal(6 * frame)
         + 1j * rng.standard_normal(6 * frame)).astype(np.complex64)
    peaks1, peaks6 = [], []
    r1._msg_handlers.setdefault("Meter.peak", []).append(
        lambda v: peaks1.append(float(v)))
    r6._msg_handlers.setdefault("Meter.peak", []).append(
        lambda v: peaks6.append(float(v)))
    seq = np.concatenate([
        np.asarray(r1.step(x[i * frame:(i + 1) * frame])[t1])
        for i in range(6)])
    got = np.asarray(r6.step(x.reshape(6, frame))[t6]).reshape(-1)
    np.testing.assert_array_equal(got, seq)
    assert len(peaks6) == 6
    np.testing.assert_array_equal(peaks6, peaks1)


def test_default_auto_dispatch_contract():
    """Round-4 default: compile() with no knobs is auto-dispatch.  step()
    keeps exact per-frame semantics for per-frame feeds AND accepts
    stacked [K, ...] feeds; run() batches per-frame iterators to K and
    the emitted stream equals per-frame stepping bit-for-bit."""
    rng = np.random.default_rng(9)
    g1, lpf1, tap1 = _lpf_mag_graph()
    frame = lpf1.quantum * 2
    r1 = g1.compile(frame_size=frame)          # NO knobs
    assert r1.auto_dispatch and r1.steps_per_dispatch >= 1
    k = r1.steps_per_dispatch

    nfr = 2 * k + 3                            # exercises the remainder path
    x = (rng.standard_normal(nfr * frame)
         + 1j * rng.standard_normal(nfr * frame)).astype(np.complex64)
    frames = [x[i * frame:(i + 1) * frame] for i in range(nfr)]

    # per-frame step() on the default runner = original semantics
    seq = np.concatenate([np.asarray(r1.step(f)[tap1]) for f in frames])

    # run() on a fresh identical runner batches internally
    g2, _, tap2 = _lpf_mag_graph()
    r2 = g2.compile(frame_size=frame)
    outs = r2.run(iter([(f,) for f in frames]))
    got = np.concatenate([np.asarray(o[tap2]).reshape(-1) for o in outs])
    np.testing.assert_array_equal(got, seq)

    # stacked feeds on the default runner take the scanned path
    g3, _, tap3 = _lpf_mag_graph()
    r3 = g3.compile(frame_size=frame)
    stacked = np.stack(frames[:k])
    out_k = np.asarray(r3.step(stacked)[tap3]).reshape(-1)
    np.testing.assert_array_equal(out_k, seq[: out_k.size])


def test_auto_dispatch_respects_declared_feed_rank():
    """A block whose per-frame feed is legitimately multi-dim
    declares ``in_rank``; a rank-matching feed whose LEADING dim happens
    to equal K must run as ONE frame, not be scanned as K frames."""
    from fractions import Fraction

    import jax.numpy as jnp

    from clenabled_tpu.streaming.block import Block

    class BundleSum(Block):
        """Consumes a [C, frame] channel bundle per step, emits the
        channel-summed frame."""
        n_inputs, n_outputs = 1, 1
        in_rank = 2

        def __init__(self, c):
            super().__init__()
            self.c = c
            self.quantum = 1
            self.rate = Fraction(1)

        def init_state(self):
            return jnp.zeros((), jnp.int32)

        def apply(self, state, ins):
            return state + 1, (jnp.sum(ins[0], axis=0),), {}

    frame = 1 << 16
    g = Flowgraph()
    blk = BundleSum(32)
    g.external_input(blk)
    tap = g.tap(blk, name="y")
    r = g.compile(frame_size=frame)            # auto-dispatch default
    k = r.steps_per_dispatch
    assert k >= 2                              # the ambiguity exists

    feed = np.random.default_rng(3).standard_normal(
        (k, frame)).astype(np.float32)         # C == K bundle, ONE frame
    out = r.step(feed)
    # one apply() ran (state is the call counter), summing axis 0
    assert int(np.asarray(r.states[0])) == 1
    np.testing.assert_allclose(np.asarray(out[tap]), feed.sum(axis=0),
                               rtol=1e-5)

    # a genuinely stacked feed for a rank-2 block is rank 3 and scans
    stacked = np.stack([feed, feed])[:k] if k == 2 else None
    if stacked is not None:
        out2 = r.step(stacked)
        assert np.asarray(out2[tap]).shape == (k, frame)


def test_stateless_graph_vmaps_and_matches_sequential():
    """Round 5: when every block is stateless the K-frame dispatch vmaps
    across frames (XLA batches the per-frame kernels).  Results must
    match per-frame stepping to fp tolerance, and carried state must be
    untouched."""
    from clenabled_tpu.dsp import planar

    def graph():
        g = Flowgraph()
        xc = blocks.XCorrelateFFTVCF(1024, 2)
        for p in range(2):
            g.external_input(xc, p)
        tap = g.tap(xc, name="corr")
        return g, tap

    rng = np.random.default_rng(5)
    g1, tap1 = graph()
    r1 = g1.compile(frame_size=1024)
    k = r1.steps_per_dispatch
    assert k > 1 and all(b.stateless for b in r1._order)

    def pc(shape, s):
        return planar.PC(
            np.asarray(rng.standard_normal(shape), np.float32),
            np.asarray(rng.standard_normal(shape), np.float32))

    feeds = [tuple(pc((1024,), 0) for _ in range(2)) for _ in range(k)]
    seq = [np.asarray(r1.step(*f)[tap1]) for f in feeds]

    g2, tap2 = graph()
    r2 = g2.compile(frame_size=1024)
    stacked = tuple(
        planar.PC(np.stack([f[p].re for f in feeds]),
                  np.stack([f[p].im for f in feeds]))
        for p in range(2))
    got = np.asarray(r2.step(*stacked)[tap2])
    assert got.shape[0] == k
    np.testing.assert_allclose(got, np.stack(seq), rtol=1e-4, atol=1e-4)


def test_stateful_graph_keeps_scan_dispatch():
    """A graph containing any stateful block must keep the exact
    lax.scan state threading (bit-identical to sequential stepping)."""
    g, lpf, tap = _lpf_mag_graph()
    frame = lpf.quantum * 2
    r = g.compile(frame_size=frame, steps_per_dispatch=4)
    assert not all(getattr(b, "stateless", False) for b in r._order)
