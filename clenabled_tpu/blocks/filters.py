"""Filter blocks: clFilter family, clComplexFilter, clPolyphaseChannelizer."""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np


def _resize_tail(vec, new_len: int, keep_recent: bool):
    """Translate a carried 1-D tail/history to a new length.

    keep_recent=True (input-domain state: the TD history): keep the
    most recent samples, left-pad zeros — exact continuity where the taps
    agree, a ≤(Δntaps)-sample transient otherwise.  keep_recent=False
    (output-domain state: the OFA tail t[j] = contribution to future output
    j): keep the head, right-pad zeros."""
    cur = vec.shape[-1]
    if cur == new_len:
        return vec
    if keep_recent:
        if cur > new_len:
            return vec[..., cur - new_len:]
        pad = jnp.zeros(vec.shape[:-1] + (new_len - cur,), vec.dtype)
        return jnp.concatenate([pad, vec], axis=-1)
    if cur > new_len:
        return vec[..., :new_len]
    pad = jnp.zeros(vec.shape[:-1] + (new_len - cur,), vec.dtype)
    return jnp.concatenate([vec, pad], axis=-1)

from clenabled_tpu.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu.dsp import channelizer as dsp_chan
from clenabled_tpu.dsp import fft_filter as dsp_ofa
from clenabled_tpu.dsp import fir_filter as dsp_fir
from clenabled_tpu.dsp import firdes
from clenabled_tpu.streaming.block import Block


class Filter(Block):
    """clFilter (lib/clFilter_impl.cc): complex stream, float taps, with
    time-domain (direct FIR) or frequency-domain (overlap-add) mode —
    the reference's ``use_time`` ctor flag (include/clenabled/clFilter.h:32,
    default frequency-domain)."""

    def __init__(self, decimation: int, taps, use_time: bool = False,
                 planar: bool = False, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.decimation = decimation
        self.rate = Fraction(1, decimation)
        self.use_time = use_time
        self.planar = planar
        self._set(np.asarray(taps, np.float32))

    def _set(self, taps):
        self._taps = taps
        ntaps = int(np.shape(taps)[-1])
        if self.use_time:
            if self.planar:
                self._init, self._apply = dsp_fir.make_fir_filter_planar_xla(
                    taps, self.decimation)
            else:
                self._init, self._apply = dsp_fir.make_fir_filter(
                    taps, self.decimation, complex_input=True)
            self.quantum = self.decimation
            self._state_kind, self._state_len = "td", ntaps - 1
        else:
            if self.planar:
                self._init, self._apply, self._plan = (
                    dsp_ofa.make_fft_filter_planar(taps, self.decimation))
            else:
                self._init, self._apply, self._plan = dsp_ofa.make_fft_filter(
                    taps, self.decimation)
            self.quantum = dsp_ofa.frame_quantum(self._plan)
            # overlap-add: the tail is output-domain state
            self._state_kind, self._state_len = "ofa", ntaps - 1

    def taps(self):
        return self._taps

    def set_taps(self, taps):
        """Rebuild kernels/plans for new taps at runtime
        (clFilter_impl.cc:417-479).  Inside a running flowgraph use
        Runner.set_taps(block, taps) — it re-traces the step and carries
        the filter tail across the rebuild (migrate_state), so the stream
        continues without a reset."""
        self._old_kind = getattr(self, "_state_kind", None)
        self._set(np.asarray(
            taps, np.complex64 if np.iscomplexobj(taps) else np.float32))

    set_taps2 = set_taps

    def migrate_state(self, old_state):
        """Translate the carried tail across a set_taps rebuild: where old
        and new taps agree the output stream is unchanged; otherwise the
        transient is bounded by the tap-count delta (input-domain state) or
        the old tail length (output-domain state)."""
        old_kind = getattr(self, "_old_kind", None)
        self._old_kind = None
        if old_kind is None:               # no reconfiguration since last time
            return old_state
        if old_kind != self._state_kind:   # plan family changed — no mapping
            return self.init_state()
        keep_recent = self._state_kind == "td"
        if isinstance(old_state, tuple):
            return tuple(_resize_tail(s, self._state_len, keep_recent)
                         for s in old_state)
        return _resize_tail(old_state, self._state_len, keep_recent)

    def init_state(self):
        return self._init()

    def apply(self, state, inputs):
        state, out = self._apply(state, inputs[0])
        return state, (out,), {}


class ComplexFilter(Filter):
    """clComplexFilter (lib/clComplexFilter_impl.cc): complex taps,
    time-domain only in the reference; both modes here."""

    def __init__(self, decimation: int, taps, use_time: bool = True,
                 planar: bool = False, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.decimation = decimation
        self.rate = Fraction(1, decimation)
        self.use_time = use_time
        self.planar = planar
        self._set(np.asarray(taps, np.complex64))

    def _set(self, taps):
        self._taps = taps
        ntaps = int(np.shape(taps)[-1])
        if self.use_time:
            if self.planar:
                self._init, self._apply = dsp_fir.make_fir_filter_planar_xla(
                    taps, self.decimation)
            else:
                self._init, self._apply = dsp_fir.make_fir_filter(
                    taps, self.decimation, complex_input=True)
            self.quantum = self.decimation
            self._state_kind, self._state_len = "td", ntaps - 1
        else:
            if self.planar:
                self._init, self._apply, self._plan = (
                    dsp_ofa.make_fft_filter_planar(taps, self.decimation))
            else:
                self._init, self._apply, self._plan = dsp_ofa.make_fft_filter(
                    taps, self.decimation)
            self.quantum = dsp_ofa.frame_quantum(self._plan)
            self._state_kind, self._state_len = "ofa", ntaps - 1

    def set_taps(self, taps):
        """Rebuild for new COMPLEX taps (clComplexFilter set_taps2); use
        Runner.set_taps for a live retune with carried state."""
        self._old_kind = getattr(self, "_state_kind", None)
        self._set(np.asarray(taps, np.complex64))

    set_taps2 = set_taps


# GRC wrapper blocks: their yml make-templates embed firdes calls
# (e.g. grc/clenabled_clLowPassFilter.block.yml:83-87).

def LowPassFilter(decimation, gain, samp_rate, cutoff_freq, transition_width,
                  window=firdes.WIN_HAMMING, beta=6.76, use_time=False,
                  planar=False, name="lowpass", **legacy):
    taps = firdes.low_pass(gain, samp_rate, cutoff_freq, transition_width,
                           window, beta)
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


def HighPassFilter(decimation, gain, samp_rate, cutoff_freq, transition_width,
                   window=firdes.WIN_HAMMING, beta=6.76, use_time=False,
                   planar=False, name="highpass", **legacy):
    taps = firdes.high_pass(gain, samp_rate, cutoff_freq, transition_width,
                            window, beta)
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


def BandPassFilter(decimation, gain, samp_rate, low_cutoff, high_cutoff,
                   transition_width, window=firdes.WIN_HAMMING, beta=6.76,
                   use_time=False, planar=False, name="bandpass", **legacy):
    taps = firdes.band_pass(gain, samp_rate, low_cutoff, high_cutoff,
                            transition_width, window, beta)
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


def BandRejectFilter(decimation, gain, samp_rate, low_cutoff, high_cutoff,
                     transition_width, window=firdes.WIN_HAMMING, beta=6.76,
                     use_time=False, planar=False, name="bandreject", **legacy):
    taps = firdes.band_reject(gain, samp_rate, low_cutoff, high_cutoff,
                              transition_width, window, beta)
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


def RootRaisedCosineFilter(decimation, gain, samp_rate, symbol_rate, alpha,
                           ntaps, use_time=False, planar=False, name="rrc",
                           **legacy):
    taps = firdes.root_raised_cosine(gain, samp_rate, symbol_rate, alpha, ntaps)
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


def FIRTapFilter(decimation, taps, use_time=False, planar=False,
                 name="fir_taps", **legacy):
    """clFIRTapFilter: general user-supplied taps."""
    return Filter(decimation, taps, use_time=use_time, planar=planar,
                  name=name, **legacy)


class FirFilterSCC(Block):
    """short→complex FIR block (the reference's fir_filter_scc CPU variant,
    lib/fir_filter.h:160): int16 stream in, complex taps, complex64 out —
    the DTYPE_SHORT stream path through the block layer."""

    def __init__(self, decimation: int, taps, name: str = "scc", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.decimation = decimation
        self.rate = Fraction(1, decimation)
        self.quantum = decimation
        self._taps = np.asarray(taps, np.complex64)
        self._init, self._apply = dsp_fir.make_fir_filter_typed(
            self._taps, decimation, in_dtype=jnp.int16)

    def taps(self):
        return self._taps

    def init_state(self):
        return self._init()

    def apply(self, state, inputs):
        state, out = self._apply(state, inputs[0])
        return state, (out,), {}


class FirFilterFSF(Block):
    """float→short FIR block (the reference's fir_filter_fsf CPU variant,
    lib/fir_filter.h:192): float32 stream in, float taps, int16 out with
    C truncation-toward-zero narrowing."""

    def __init__(self, decimation: int, taps, name: str = "fsf", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.decimation = decimation
        self.rate = Fraction(1, decimation)
        self.quantum = decimation
        self._taps = np.asarray(taps, np.float32)
        self._init, self._apply = dsp_fir.make_fir_filter_typed(
            self._taps, decimation, in_dtype=jnp.float32,
            out_dtype=jnp.int16)

    def taps(self):
        return self._taps

    def init_state(self):
        return self._init()

    def apply(self, state, inputs):
        state, out = self._apply(state, inputs[0])
        return state, (out,), {}


class PolyphaseChannelizer(Block):
    """clPolyphaseChannelizer (lib/clPolyphaseChannelizer_impl.cc): M-channel
    PFB with oversampling (ninputs_per_iter ≤ M) and output channel map.

    Output stream: interleaved selected channels, matching the reference's
    [sample-group][ch_map] output order (out rate = len(ch_map)/R)."""

    def __init__(self, taps, buf_items: int, num_channels: int,
                 ninputs_per_iter: int, ch_map, planar: bool = False,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        if buf_items % num_channels:
            raise ValueError("buf_items must be a multiple of num_channels")
        if buf_items % ninputs_per_iter:
            raise ValueError("buf_items must be a multiple of ninputs_per_iter")
        self.name = name
        self.num_channels = num_channels
        self.ninputs_per_iter = ninputs_per_iter
        self.ch_map = list(ch_map)
        self.quantum = buf_items
        self.rate = Fraction(len(self.ch_map), ninputs_per_iter)
        self.planar = planar
        self._init, self._apply = dsp_chan.make_channelizer(
            taps, num_channels, ninputs_per_iter, self.ch_map, planar=planar)

    def init_state(self):
        return self._init()

    def apply(self, state, inputs):
        from clenabled_tpu.dsp import planar

        state, out = self._apply(state, inputs[0])  # [n, C]
        if isinstance(out, planar.PC):
            flat = planar.PC(out.re.reshape(-1), out.im.reshape(-1))
        else:
            flat = out.reshape(-1)
        return state, (flat,), {}


class InterpFirFilter(Block):
    """Polyphase interpolating FIR (GR interp_fir_filter_ccf contract —
    the reference has no interpolator; added so flowgraphs cover GR's full
    multi-rate forecast surface).  Output rate = interp × input rate;
    float taps; planar=True streams planar.PC frames."""

    def __init__(self, interp: int, taps, planar: bool = False,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        if interp < 1:
            raise ValueError("interp must be >= 1")
        self.name = name
        self.interp = interp
        self.rate = Fraction(interp)
        self.planar = planar
        if planar:
            self._init, self._apply = dsp_fir.make_interp_fir_filter_planar(
                taps, interp)
        else:
            self._init, self._apply = dsp_fir.make_interp_fir_filter(
                taps, interp)

    def init_state(self):
        return self._init()

    def apply(self, state, inputs):
        state, out = self._apply(state, inputs[0])
        return state, (out,), {}
