"""Planar OFA filter and planar TD xcorr parity vs the complex paths."""

from clenabled_tpu.dsp import planar

import numpy as np

from clenabled_tpu.dsp import fft_filter, firdes, xcorr

RNG = np.random.default_rng(55)


def test_planar_ofa_matches_complex():
    taps = firdes.root_raised_cosine(1.0, 10e6, 1e6, 0.22, 241)
    ic, ac, plan = fft_filter.make_fft_filter(taps)
    ip, ap, _ = fft_filter.make_fft_filter_planar(taps)
    n = plan.nsamples * 8
    sc, sp = ic(), ip()
    for _ in range(3):
        x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
            np.complex64)
        sc, yc = ac(sc, x)
        sp, y = ap(sp, planar.from_complex(x))
        yr, yi = y.re, y.im
        np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi),
                                   np.asarray(yc), rtol=2e-3, atol=2e-3)


def test_planar_ofa_decimation():
    taps = firdes.low_pass(1.0, 1e6, 80e3, 20e3)
    ic, ac, plan = fft_filter.make_fft_filter(taps, decimation=4)
    ip, ap, _ = fft_filter.make_fft_filter_planar(taps, decimation=4)
    q = fft_filter.frame_quantum(plan)
    x = (RNG.standard_normal(2 * q) + 1j * RNG.standard_normal(2 * q)).astype(
        np.complex64)
    _, yc = ac(ic(), x)
    _, y = ap(ip(), planar.from_complex(x))
    yr, yi = y.re, y.im
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi),
                               np.asarray(yc), rtol=2e-3, atol=2e-3)


def test_planar_td_xcorr_matches():
    n, shift = 4096, 256
    sigs = RNG.standard_normal((3, n)).astype(np.float32)
    want = xcorr.td_xcorr(sigs, shift)
    got = xcorr.td_xcorr_planar(sigs, shift)
    np.testing.assert_allclose(np.asarray(got.corr_vectors),
                               np.asarray(want.corr_vectors),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(got.lag), np.asarray(want.lag))


def test_planar_fir_streaming_matches_complex():
    """The planar TD FIR, carried over two frames, equals the complex64
    FIR on the same stream."""
    from clenabled_tpu.dsp import fir_filter as ff

    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    n = 128 * 64
    ic, ac = ff.make_fir_filter(taps)
    ip, ap = ff.make_fir_filter_planar_xla(taps)
    sc, sp = ic(), ip()
    for _ in range(2):
        x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
            np.complex64)
        sc, yc = ac(sc, x)
        sp, y = ap(sp, planar.from_complex(x))
        np.testing.assert_allclose(np.asarray(y.re) + 1j * np.asarray(y.im),
                                   np.asarray(yc), rtol=1e-4, atol=1e-4)


def test_planar_ofa_single_quantum_frame():
    """A frame of exactly one quantum (a single overlap-add chunk), then a
    second one carrying the tail, matches the direct convolution."""
    from clenabled_tpu.dsp import fft_filter as ff

    taps = firdes.low_pass(1.0, 1e6, 100e3, 20e3)
    init, apply, plan = ff.make_fft_filter_planar(taps)
    q = ff.frame_quantum(plan)
    assert q == plan.nsamples
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(2 * q)
         + 1j * rng.standard_normal(2 * q)).astype(np.complex64)
    st = init()
    got = []
    for k in range(2):
        st, y = apply(st, planar.from_complex(x[k * q:(k + 1) * q]))
        got.append(np.asarray(y.re) + 1j * np.asarray(y.im))
    want = np.convolve(x, taps)[:2 * q]
    np.testing.assert_allclose(np.concatenate(got), want, atol=1e-4)
