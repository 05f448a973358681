"""Planar execution mode for the BLOCK layer: the same flowgraphs built
with planar=True / PC feeds must reproduce the complex-mode outputs."""

import numpy as np
import pytest

from clenabled_tpu import blocks
from clenabled_tpu.dsp import demod, planar, window as win
from clenabled_tpu.streaming import Flowgraph

RNG = np.random.default_rng(71)


def cplx(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64
    )


def test_planar_source_fft_mag_chain():
    """The minimum slice, planar: SignalSource→Fft→MultiplyConst→Mag."""
    fs, f0, n = 1e6, 250e3, 8192

    def build(pl):
        g = Flowgraph()
        src = blocks.SignalSource(fs, 1, f0, 1.0, n, planar=pl)
        fft = blocks.Fft(2048, window=win.blackman_harris(2048), shift=True)
        mc = blocks.MultiplyConst(2.0)
        mag = blocks.ComplexToMag()
        g.connect(src, fft)
        g.connect(fft, mc)
        g.connect(mc, mag)
        t = g.tap(mag)
        return g.compile(), t

    rc, tc = build(False)
    rp, tp = build(True)
    want = np.asarray(rc.step()[tc])
    got = np.asarray(rp.step()[tp])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def test_planar_filter_demod_chain():
    """LPF(freq) → QuadratureDemod, planar vs complex over 2 frames."""
    frame = None
    x = cplx(0)

    def build(pl):
        g = Flowgraph()
        lpf = blocks.LowPassFilter(1, 1.0, 1e6, 150e3, 50e3, planar=pl)
        qd = blocks.QuadratureDemod(0.7, planar=pl)
        g.external_input(lpf)
        g.connect(lpf, qd)
        t = g.tap(qd)
        return g, lpf, t

    gc, lpfc, tc = build(False)
    gp, _, tp = build(True)
    frame = lpfc.quantum * 4
    rc = gc.compile(frame_size=frame)
    rp = gp.compile(frame_size=frame)
    for _ in range(2):
        x = cplx(frame)
        want = np.asarray(rc.step(x)[tc])
        got = np.asarray(rp.step(planar.from_complex(x))[tp])
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_planar_costas_matches_complex():
    bits = RNG.integers(0, 2, 1024) * 2 - 1
    x = (bits * np.exp(1j * 0.3)).astype(np.complex64)
    run_c = demod.make_costas_loop(0.02, 2)
    run_p = demod.make_costas_loop_planar(0.02, 2)
    _, out_c = run_c(demod.costas_init(), x)
    _, out_p = run_p(demod.costas_init(), planar.from_complex(x))
    np.testing.assert_allclose(planar.to_complex(out_p), np.asarray(out_c),
                               rtol=1e-4, atol=1e-4)


def test_planar_channelizer_block():
    from clenabled_tpu.dsp import firdes

    m = 8
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)

    def build(pl):
        g = Flowgraph()
        ch = blocks.PolyphaseChannelizer(taps, 512, m, m, list(range(m)),
                                         planar=pl)
        g.external_input(ch)
        t = g.tap(ch)
        return g.compile(frame_size=512), t

    rc, tc = build(False)
    rp, tp = build(True)
    x = cplx(512)
    want = np.asarray(rc.step(x)[tc])
    got_pc = rp.step(planar.from_complex(x))[tp]
    got = np.asarray(got_pc.re) + 1j * np.asarray(got_pc.im)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_planar_xcorrelate_block():
    n, shift, delay = 4096, 256, 21
    base = RNG.standard_normal(2 * n).astype(np.float32)
    a = (base[512 : 512 + n] + 0j).astype(np.complex64)
    b = (base[512 - delay : 512 - delay + n] + 0j).astype(np.complex64)
    xc = blocks.XCorrelate(2, signal_length=n, max_search_index=shift)
    g = Flowgraph()
    g.external_input(xc, 0)
    g.external_input(xc, 1)
    r = g.compile(frame_size=n)
    res = []
    r.on_message("xcorr.corr", lambda m: res.append(m))
    r.step(planar.from_complex(a), planar.from_complex(b))
    assert int(np.asarray(res[0]["corrective_lags"])[0]) == -delay


def test_planar_xengine_block():
    s, f, t, npol = 4, 16, 32, 1
    xe_c = blocks.XEngine(1, npol, s, num_channels=f, integration=t)
    xe_p = blocks.XEngine(1, npol, s, num_channels=f, integration=t,
                          planar=True)
    feeds = [cplx(t * f * npol) for _ in range(s)]

    def run(xe, feeds):
        g = Flowgraph()
        for i in range(s):
            g.external_input(xe, i)
        r = g.compile(frame_size=t * f * npol)
        out = []
        r.on_message("xengine.xcorr", lambda m: out.append(m))
        r.step(*feeds)
        return out[0]

    mc = run(xe_c, feeds)
    mp = run(xe_p, [planar.from_complex(f_) for f_ in feeds])
    got = np.asarray(mp["matrix"].re) + 1j * np.asarray(mp["matrix"].im)
    np.testing.assert_allclose(got, np.asarray(mc["matrix"]),
                               rtol=1e-3, atol=1e-3)
