"""Golden parity for the reference's GENERATED (OpenCL kernel-string)
semantics.  The vectors in
golden/kernels_golden.json come from tests/golden_gen/gen3.cc, a cited
host-loop transcription of the kernel strings the reference builds at
runtime (PFB commutator/rotation/ch_map, the three clFFT shift/hermitian
assemblies, the TD lag scan + find_max, the FD conj-mult + half-swap, and
the X-Engine cxmac + IChar/packed-4-bit decodes).  These replace the
Python-transcribed oracles on exactly the paths where transcription bias
(commutator indexing, shift-on-load vs shift-on-store, nibble conventions)
was the last uncovered bug class."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" /
     "kernels_golden.json").read_text())


def as_complex(flat):
    a = np.asarray(flat, np.float32)
    return (a[0::2] + 1j * a[1::2]).astype(np.complex64)


# ------------------------------------------------------------------- PFB

@pytest.mark.parametrize("idx", range(len(GOLDEN["pfb"])))
def test_pfb_streaming_golden(idx):
    """Streaming PFB commutator + oversampling rotation + unscaled
    backward DFT + ch_map vs the reference kernel's host transcription
    (clPolyphaseChannelizer_impl.cc:156-177), over 3 consecutive work
    calls (cross-call history continuity).  For R < M the reference's
    last (M-R)/R groups per call read past its device buffer (see
    gen3.cc) — those groups are excluded."""
    from clenabled_tpu.dsp import channelizer

    g = GOLDEN["pfb"][idx]
    m, r, ntaps, b = g["m"], g["r"], g["ntaps"], g["buf_items"]
    taps = np.asarray(g["taps"], np.float32)
    stream = as_complex(g["stream"])
    ch_map = g["ch_map"]
    skip = g["skip_last_groups"]
    nch = len(ch_map)
    groups = b // r

    init, apply = channelizer.make_channelizer(taps, m, r, ch_map)
    state = init()
    for call, want_flat in enumerate(g["calls"]):
        frame = stream[(ntaps - 1) + call * b:(ntaps - 1) + (call + 1) * b]
        state, out = apply(state, frame)
        got = np.asarray(out).reshape(groups, nch)
        want = as_complex(want_flat).reshape(groups, nch)
        n_ok = groups - skip
        scale = np.abs(want[:n_ok]).max()
        np.testing.assert_allclose(got[:n_ok], want[:n_ok], rtol=1e-4,
                                   atol=1e-4 * scale,
                                   err_msg=f"call {call}")


# ----------------------------------------------------------------- clFFT

def test_clfft_golden_cases():
    """The three output assemblies + window of the clFFT block
    (clFFT_impl.cc:544-630): forward-shift swaps halves after the
    transform, reverse-shift swaps at load, float input mirrors the
    hermitian half (out[N/2] unspecified in the reference), window
    multiplies before the transform."""
    from clenabled_tpu.dsp import fft as dsp_fft

    for case in GOLDEN["clfft"]:
        n = case["n"]
        want = as_complex(case["output"])
        if case["case"] == "fwd_shift":
            x = as_complex(case["input"])
            got = np.asarray(dsp_fft.fft(x, dsp_fft.FORWARD, shift=True))
        elif case["case"] == "rev_shift":
            x = as_complex(case["input"])
            got = np.asarray(dsp_fft.fft(x, dsp_fft.REVERSE, shift=True))
        elif case["case"] == "fwd_window":
            x = as_complex(case["input"])
            w = np.asarray(case["window"], np.float32)
            got = np.asarray(dsp_fft.fft(x, dsp_fft.FORWARD, window=w))
        else:  # float_fwd
            xf = np.asarray(case["input"], np.float32)
            got = np.asarray(dsp_fft.fft(xf, dsp_fft.FORWARD))
        scale = np.abs(want).max()
        if case.get("hermitian_mid_unspecified"):
            keep = np.arange(n) != n // 2
            np.testing.assert_allclose(got[keep], want[keep], rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=case["case"])
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=case["case"])


# -------------------------------------------------------------- TD xcorr

def test_td_xcorr_golden():
    """Normalized lag scan + find_max vs the XCorrelate kernel
    transcription (clXCorrelate_impl.cc:843-903, 1011-1068): window
    energy endpoints and the shift sign convention are the pinned
    semantics."""
    from clenabled_tpu.dsp import xcorr

    g = GOLDEN["td_xcorr"]
    ref = as_complex(g["ref"])
    sig = as_complex(g["sig"])
    res = xcorr.td_xcorr(np.stack([ref, sig]), g["max_shift"])
    got = np.asarray(res.corr_vectors)[0]
    want = np.asarray(g["corr"], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert int(np.argmax(got)) == g["max_index"]
    assert int(np.asarray(res.lag)[0]) == g["max_index"] - g["max_shift"]


# -------------------------------------------------------------- FD xcorr

def test_fd_xcorr_golden():
    """Conj-mult (ref·conj(sig)) + unscaled backward FFT + mag +
    half-swap, and the input_type=2 forward-FFT-first path
    (clxcorrelate_fft_vcf_impl.cc:886-937, 1040-1141)."""
    from clenabled_tpu.dsp import xcorr

    for g in GOLDEN["fd_xcorr"]:
        ref = as_complex(g["ref"])
        sig = as_complex(g["sig"])
        got = np.asarray(xcorr.fd_xcorr(
            np.stack([ref, sig]), perform_fft_first=g["fft_first"]))[0]
        want = np.asarray(g["output"], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * want.max(),
                                   err_msg=str(g["fft_first"]))


# -------------------------------------------------------------- X-Engine

@pytest.mark.parametrize("mode", ["ichar", "packed4"])
def test_xengine_cxmac_golden(mode):
    """cxmac integration (accum += z_row·conj(z_col)), xGPU triangular
    station decode, XX/XY/YX/YY pol order, pipeline '+=' across calls,
    and the IChar (1/127) / packed-4-bit (LUT 0x8→0, 1/7) decodes
    (clXEngine_impl.cc:727-790, 831-858)."""
    from clenabled_tpu.dsp import xengine

    g = next(e for e in GOLDEN["xengine"] if e["mode"] == mode)
    a, p, f, t = (g["num_inputs"], g["npol"], g["num_channels"],
                  g["integration_time"])
    nb = xengine.num_baselines(a)
    accum = np.zeros((f, nb, p * p), np.complex64)
    for call in g["calls"]:
        raw = np.asarray(call["bytes"], np.uint8)
        if mode == "ichar":
            re8, im8 = xengine.unpack_char_int8(raw.astype(np.int8))
            z = (np.asarray(re8, np.float32)
                 + 1j * np.asarray(im8, np.float32)) / 127.0
        else:
            z = np.asarray(xengine.unpack_packed_4bit(raw))
        z = z.reshape(t, a, f, p).astype(np.complex64)
        corr = np.asarray(xengine.xengine_correlate(z, npol=p))
        accum += corr
        want_flat = np.asarray(call["accum"], np.float32)
        want = (want_flat[0::2] + 1j * want_flat[1::2]).reshape(f, nb, p * p)
        np.testing.assert_allclose(accum, want, rtol=1e-4, atol=1e-5)
