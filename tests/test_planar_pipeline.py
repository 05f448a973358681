"""Planar pipeline == complex pipeline, and both flagship forms against the
float64 NumPy reference (clenabled_tpu.reference)."""

import numpy as np
import pytest

from clenabled_tpu.dsp import channelizer, planar, xcorr, xengine, firdes
from clenabled_tpu.pipelines import (FxPipelineConfig, make_fx_pipeline,
                                     make_fx_pipeline_planar)

RNG = np.random.default_rng(77)


def cplx(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


def test_channelize_planar_matches_complex():
    m, r = 16, 16
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    taps_rm, ntaps = channelizer._pfb_constants(taps, m, r)
    x = cplx(32 * m + ntaps - 1)
    want = np.asarray(channelizer._channelize(
        x, taps_rm, np.arange(m, dtype=np.int32),
        num_channels=m, ninputs_per_iter=r, ntaps=ntaps))
    got = planar.to_complex(channelizer._channelize_planar(
        planar.from_complex(x), taps_rm, np.arange(m, dtype=np.int32),
        num_channels=m, ninputs_per_iter=r, ntaps=ntaps))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_channelize_planar_oversampled():
    m, r = 8, 4
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    taps_rm, ntaps = channelizer._pfb_constants(taps, m, r)
    x = cplx(24 * m + ntaps - 1)
    want = np.asarray(channelizer._channelize(
        x, taps_rm, np.arange(m, dtype=np.int32),
        num_channels=m, ninputs_per_iter=r, ntaps=ntaps))
    got = planar.to_complex(channelizer._channelize_planar(
        planar.from_complex(x), taps_rm, np.arange(m, dtype=np.int32),
        num_channels=m, ninputs_per_iter=r, ntaps=ntaps))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_fd_xcorr_planar_matches():
    v = cplx(3, 5, 256)
    want = np.asarray(xcorr.fd_xcorr(v))
    got = np.asarray(xcorr.fd_xcorr_planar(planar.from_complex(v)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def test_xengine_planar_matches():
    z = cplx(16, 4, 8, 2)
    want = np.asarray(xengine.xengine_correlate(z, npol=2))
    got = planar.to_complex(
        xengine.xengine_correlate_planar(planar.from_complex(z), npol=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_full_pipeline_planar_matches_complex():
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=4096)
    fn_c, (xc, hc) = make_fx_pipeline(cfg)
    fn_p, (xr, xi, hr, hi) = make_fx_pipeline_planar(cfg)
    x = cplx(4, 4096)
    fd_c, xmat_c, _ = fn_c(x, hc)
    fd_p, xre, xim, _, _ = fn_p(x.real.copy(), x.imag.copy(), hr, hi)
    np.testing.assert_allclose(np.asarray(fd_p), np.asarray(fd_c),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(xre) + 1j * np.asarray(xim),
                               np.asarray(xmat_c), rtol=1e-3, atol=1e-1)


def test_reference_pfb_matches_loop_oracle():
    """reference.pfb_critical (vectorized, float64) against the loop
    transcription of the reference kernels in test_channelizer."""
    from test_channelizer import ref_channelize

    from clenabled_tpu import reference
    from clenabled_tpu.pipelines import flagship_taps

    m = 16
    taps = flagship_taps(m)
    x = cplx(2, len(taps) - 1 + 64 * m)
    got = reference.pfb_critical(x, taps, m)
    for a in range(2):
        want = ref_channelize(x[a].astype(np.complex128),
                              taps.astype(np.float64), m, m, list(range(m)))
        np.testing.assert_allclose(got[a], want, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("form", ["planar", "complex"])
def test_flagship_forms_match_reference(form):
    """Both XLA flagship forms at 2^12 samples per antenna, over two
    carried steps, against the float64 NumPy reference.  On the CPU every
    float32 op rounds once, so 1e-4 normwise covers the accumulated
    float32 rounding with a wide margin."""
    from clenabled_tpu import reference
    from clenabled_tpu.pipelines import flagship_taps

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << 12)
    taps = flagship_taps(16)
    hist_ref = np.zeros((4, len(taps) - 1), np.complex128)
    if form == "planar":
        fn, (_, _, hr, hi) = make_fx_pipeline_planar(cfg)
        state = (hr, hi)
    else:
        fn, (_, hist) = make_fx_pipeline(cfg)
        state = (hist,)
    for _ in range(2):
        x = cplx(4, 1 << 12)
        fd_w, xm_w, hist_ref = reference.flagship_step(x, hist_ref, taps, 16)
        if form == "planar":
            fd, xre, xim, *state = fn(x.real.copy(), x.imag.copy(), *state)
            xm = np.asarray(xre) + 1j * np.asarray(xim)
        else:
            fd, xm, *state = fn(x, *state)
        assert reference.normwise_rel_err(fd, fd_w) < 1e-4
        assert reference.normwise_rel_err(xm, xm_w) < 1e-4
    np.testing.assert_allclose(
        np.asarray(state[0]).real if form == "complex" else
        np.asarray(state[0]), hist_ref.real, rtol=0, atol=0)


@pytest.mark.parametrize("dt_name", ["int8", "bfloat16"])
def test_flagship_planar_narrow_ingest_equals_f32(dt_name):
    """Narrow ingest (raw IChar int8, bfloat16) is widened to float32 on
    the device before the PFB: the outputs equal the float32 pipeline's
    on the same sample values, bit for bit, across two carried steps."""
    import jax.numpy as jnp

    dt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}[dt_name]
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << 12)
    fn_n, (xr0, _, hr_n, hi_n) = make_fx_pipeline_planar(cfg, in_dtype=dt)
    fn_f, (_, _, hr_f, hi_f) = make_fx_pipeline_planar(cfg)
    assert xr0.dtype == dt and hr_n.dtype == jnp.float32
    for _ in range(2):
        q = RNG.integers(-127, 128, (2, 4, 1 << 12))
        xr, xi = jnp.asarray(q[0], dt), jnp.asarray(q[1], dt)
        out_n = fn_n(xr, xi, hr_n, hi_n)
        out_f = fn_f(xr.astype(jnp.float32), xi.astype(jnp.float32),
                     hr_f, hi_f)
        for a, b in zip(out_n, out_f):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        hr_n, hi_n = out_n[3:]
        hr_f, hi_f = out_f[3:]


def test_exact_f32_context():
    """clenabled_tpu.exact_f32() wraps jax.default_matmul_precision and the
    pipelines trace/run inside it (numerically a no-op on the CPU, where
    float32 dots are exact already)."""
    import clenabled_tpu

    cfg = FxPipelineConfig(num_antennas=2, num_channels=16,
                           samples_per_step=1 << 12)
    fn, (xr0, xi0, hr, hi) = make_fx_pipeline_planar(cfg)
    xr = RNG.standard_normal(xr0.shape).astype(np.float32)
    xi = RNG.standard_normal(xi0.shape).astype(np.float32)
    with clenabled_tpu.exact_f32():
        fd_e, xre_e, *_ = fn(xr, xi, hr, hi)
    fd_d, xre_d, *_ = fn(xr, xi, hr, hi)
    np.testing.assert_allclose(np.asarray(fd_e), np.asarray(fd_d),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xre_e), np.asarray(xre_d),
                               rtol=1e-5, atol=1e-4)


def test_reference_fd_xcorr_matches_dsp_correlator():
    """reference.fd_xcorr_mean equals the frame average of dsp.xcorr's
    fd_xcorr (the clxcorrelate_fft_vcf port) on the same spectra."""
    from clenabled_tpu import reference

    spec = cplx(3, 32, 16)
    want = np.asarray(xcorr.fd_xcorr(spec)).mean(axis=1)
    np.testing.assert_allclose(reference.fd_xcorr_mean(spec), want,
                               rtol=1e-5, atol=1e-5)


def test_reference_xengine_matches_loop_oracle():
    """reference.xengine_triangular against the cxmac loop transcription
    of the reference kernel in test_xengine (single polarization)."""
    from test_xengine import ref_xengine

    from clenabled_tpu import reference

    spec = cplx(4, 8, 5).astype(np.complex128)               # [S, T, F]
    want = ref_xengine(np.transpose(spec, (1, 0, 2))[..., None], 1)
    np.testing.assert_allclose(reference.xengine_triangular(spec), want,
                               rtol=1e-12, atol=1e-12)


def test_flagship_planar_deep_prototype_matches_reference():
    """A 1600-tap prototype (100 taps per branch) through proto_taps: the
    carried history grows to ntaps−1 and the step matches the float64
    reference."""
    from clenabled_tpu import reference
    from clenabled_tpu.pipelines import flagship_taps

    proto = (np.sinc(np.linspace(-4, 4, 1600))
             * np.hanning(1600)).astype(np.float32)
    taps = flagship_taps(16, proto_taps=proto)
    assert len(taps) == 1600
    cfg = FxPipelineConfig(num_antennas=2, num_channels=16,
                           samples_per_step=1 << 13)
    fn, (_, _, hr, hi) = make_fx_pipeline_planar(cfg, proto_taps=proto)
    assert hr.shape == (2, 1599)
    hist = (RNG.standard_normal((2, 1599))
            + 1j * RNG.standard_normal((2, 1599))).astype(np.complex64)
    x = cplx(2, 1 << 13)
    fd, xre, xim, nhr, _ = fn(x.real.copy(), x.imag.copy(),
                              hist.real.copy(), hist.imag.copy())
    fd_w, xm_w, hist_w = reference.flagship_step(x, hist, taps, 16)
    assert reference.normwise_rel_err(fd, fd_w) < 1e-4
    assert reference.normwise_rel_err(
        np.asarray(xre) + 1j * np.asarray(xim), xm_w) < 1e-4
    np.testing.assert_array_equal(np.asarray(nhr), hist_w.real)


def test_sharded_flagship_rejects_block_shorter_than_halo():
    from clenabled_tpu.pipelines import make_sharded_fx_pipeline
    from clenabled_tpu.sharding import make_mesh

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=256)
    with pytest.raises(ValueError, match="halo"):
        make_sharded_fx_pipeline(make_mesh(), cfg=cfg)
