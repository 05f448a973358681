"""Correlator blocks: XCorrelate (TD), XCorrelateFFTVCF (FD), XEngine (FX)."""

from __future__ import annotations


import jax
import jax.numpy as jnp

from clenabled_tpu.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu.dsp import xcorr as dsp_xcorr
from clenabled_tpu.dsp import xengine as dsp_xengine
from clenabled_tpu.streaming.block import Block


class XCorrelate(Block):
    """clXCorrelate (lib/clXCorrelate_impl.cc): N-input time-domain
    reference correlator.  Sink block — results leave via the "corr"
    message port as (corr, lag, corr_vectors, valid), matching the
    reference's PDU dict {corrvect, corrective_lags} (:1594-1601).

    ``decim_frames`` processes 1 in N analysis frames (:1540-1548); skipped
    frames cost nothing (lax.cond).  The reference's async worker-thread
    mode is unnecessary here — JAX dispatch is already asynchronous, so
    work() never blocks on the correlation.
    """

    n_outputs = 0
    msg_ports = ("corr",)

    def __init__(self, num_inputs: int, signal_length: int = 8192,
                 data_type: int = 1, data_size: int = 8,
                 max_search_index: int = 512, decim_frames: int = 1,
                 asynchronous: bool = False, accumulate_frames: int = 1,
                 name: str = "xcorr", **legacy):
        legacy.pop("async", None)
        strip_legacy_kwargs(legacy, self)
        del data_type, data_size, asynchronous  # dtype comes from the stream
        if num_inputs < 2:
            raise ValueError("XCorrelate needs >= 2 inputs")
        self.name = name
        self.n_inputs = num_inputs
        self.signal_length = signal_length
        self.max_shift = max_search_index
        self.decim_frames = max(1, decim_frames)
        # >1 dispatches N analysis windows per device call — one 8192-
        # sample window (the reference's default) per dispatch leaves the
        # device mostly idle; results gain a leading window axis in the
        # "corr" message
        self.accumulate_frames = max(1, accumulate_frames)
        self.quantum = signal_length * self.accumulate_frames

    def init_state(self):
        return jnp.int32(0)  # analysis-window counter

    def apply(self, state, inputs):
        from clenabled_tpu.dsp import planar

        sl = self.signal_length
        first = inputs[0].re if isinstance(inputs[0], planar.PC) else inputs[0]
        # ALL whole windows in the frame — the multi-rate solver may pick a
        # super-frame that is a larger multiple of the quantum than
        # accumulate_frames·signal_length; no samples are dropped
        nb = first.shape[-1] // sl

        def windows(x):
            """[..., nb·sl] → [nb, sl] windows of one input stream."""
            return x[..., : nb * sl].reshape(nb, sl)

        if isinstance(inputs[0], planar.PC):
            mags = [planar.pabs(planar.PC(windows(x.re), windows(x.im)))
                    for x in inputs]
            sigs = jnp.stack(mags)             # [A, nb, sl]
            correlate = lambda s: dsp_xcorr.td_xcorr_planar_batched(
                s, self.max_shift)
        else:
            sigs = jnp.stack([windows(x) for x in inputs])
            correlate = lambda s: dsp_xcorr.td_xcorr_batched(s, self.max_shift)
        # 1-in-N frame decimation (:1540-1548) as a per-window validity
        # mask over the global window counter
        widx = state + jnp.arange(nb, dtype=jnp.int32)
        valid = widx % self.decim_frames == 0   # [nb]
        if nb == 1:
            # single window: skipped frames cost nothing (lax.cond)
            na = self.n_inputs - 1

            def compute(s):
                r = correlate(s)
                return r.corr, r.lag, r.corr_vectors

            def skip(s):
                return (jnp.zeros((na, 1), jnp.float32),
                        jnp.zeros((na, 1), jnp.int32),
                        jnp.zeros((na, 1, 2 * self.max_shift), jnp.float32))

            res_c, res_l, res_v = jax.lax.cond(valid[0], compute, skip, sigs)
            corr, lag, vectors = res_c[:, 0], res_l[:, 0], res_v[:, 0]
            valid = valid[0]
        else:
            res = correlate(sigs)
            # leading window axis: [nb, A-1(, 2·max_shift)]
            corr = jnp.swapaxes(res.corr, 0, 1)
            lag = jnp.swapaxes(res.lag, 0, 1)
            vectors = jnp.swapaxes(res.corr_vectors, 0, 1)
        msg = {"corr": {"corr": corr, "corrective_lags": lag,
                        "corrvect": vectors, "valid": valid}}
        return state + nb, (), msg


class XCorrelateFFTVCF(Block):
    """clxcorrelate_fft_vcf (lib/clxcorrelate_fft_vcf_impl.cc): N complex
    FFT-vector inputs → N-1 float correlation-magnitude vector outputs.
    input_type=1 expects spectra; 2 raw time series (FFT applied first)."""

    stateless = True

    def __init__(self, fft_size: int, num_inputs: int, input_type: int = 1,
                 accumulate_frames: int = 1, name: str = "fd_xcorr",
                 **legacy):
        strip_legacy_kwargs(legacy, self)
        if num_inputs < 2:
            raise ValueError("needs >= 2 inputs")
        self.name = name
        self.fft_size = fft_size
        self.n_inputs = num_inputs
        self.n_outputs = num_inputs - 1
        self.out_kinds = ("f",) * self.n_outputs
        self.perform_fft_first = input_type == 2
        # the per-vector math already batches every vector in the frame in
        # ONE dispatch; accumulate_frames raises the frame quantum so the
        # Runner feeds ≥N vectors per step instead of one 8192-pt vector
        # (the reference's default) per dispatch
        self.accumulate_frames = max(1, accumulate_frames)
        self.quantum = fft_size * self.accumulate_frames

    def apply(self, state, inputs):
        from clenabled_tpu.dsp import planar

        if isinstance(inputs[0], planar.PC):
            v = planar.PC(
                jnp.stack([x.re for x in inputs]).reshape(
                    self.n_inputs, -1, self.fft_size),
                jnp.stack([x.im for x in inputs]).reshape(
                    self.n_inputs, -1, self.fft_size))
            out = dsp_xcorr.fd_xcorr_planar(
                v, perform_fft_first=self.perform_fft_first)
        else:
            v = jnp.stack(inputs).reshape(self.n_inputs, -1, self.fft_size)
            out = dsp_xcorr.fd_xcorr(v, perform_fft_first=self.perform_fft_first)
        flat = tuple(out[i].reshape(-1) for i in range(self.n_outputs))
        return state, flat, {}


class XEngine(Block):
    """clXEngine (lib/clXEngine_impl.cc): xGPU-style FX correlator sink.

    Each of the N antenna inputs carries one integration window per step:
    ``integration_time × num_channels × npol`` interleaved complex samples in
    [time][channel][pol] order (the reference marshals the same layout
    host-side, :982-1061).  Emits the correlation matrix on the "xcorr"
    message port (with a ``valid`` flag when pipeline_integration > 1 holds
    it back), in triangular xGPU order or full-matrix format.

    File/disk output, antenna metadata sidecars and the ATA synchronizer
    live at the tools/streaming layer, not in the math block.

    channel_major (default ON for planar mode) marshals integrations into
    the channel-major [F, T, S·P] layout and runs the single-matmul stacked
    Gram engine (dsp_xengine.xengine_correlate_stacked) — for IChar /
    packed-4-bit ingest the samples stay int8 all the way to the int8
    matmul (s8×s8→s32, exact).
    """

    n_outputs = 0
    msg_ports = ("xcorr",)

    def __init__(self, data_type: int, polarization: int, num_inputs: int,
                 output_format: int = dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                 first_channel: int = 0, num_channels: int = 256,
                 integration: int = 1024, antenna_list=None,
                 pipeline_integration: int = 0, planar: bool = False,
                 channel_major: bool | None = None, compute_dtype=None,
                 name: str = "xengine", **legacy):
        for k in ("output_file", "file_base", "rollover_size_mb",
                  "internal_synchronizer", "sync_timestamp", "object_name",
                  "starting_chan_center_freq", "channel_width",
                  "disable_output"):
            legacy.pop(k, None)
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.data_type = data_type
        self.npol = polarization
        self.n_inputs = num_inputs
        self.num_channels = num_channels
        self.integration = integration
        self.first_channel = first_channel
        self.antenna_list = list(antenna_list or [])
        self.output_format = output_format
        # stream items per integration window: complex samples, or raw bytes
        # (2 bytes/sample for IChar, 1 packed byte/sample for PackedXY)
        samples = integration * num_channels * self.npol
        self.quantum = samples * 2 if data_type == 5 else samples
        self.planar = planar
        if channel_major and not planar:
            raise ValueError(
                "channel_major (the stacked Gram engine) is planar-only — "
                "pass planar=True")
        if channel_major is None:
            channel_major = planar
        self.channel_major = bool(channel_major) and planar
        if self.channel_major:
            # raw-int ingest: quantization scale applied once on the Gram
            scale = {5: 1.0 / 127.0 ** 2, 6: 1.0 / 7.0 ** 2}.get(
                data_type, 1.0)
            self._init, self._apply = dsp_xengine.make_xengine_channel_major(
                num_inputs=num_inputs, num_channels=num_channels,
                npol=self.npol, integration_time=integration,
                output_format=output_format,
                pipeline_integration=pipeline_integration,
                compute_dtype=compute_dtype, scale=scale,
            )
        else:
            self._init, self._apply = dsp_xengine.make_xengine(
                num_inputs=num_inputs, num_channels=num_channels,
                npol=self.npol, integration_time=integration,
                output_format=output_format,
                pipeline_integration=pipeline_integration, planar=planar,
            )

    def init_state(self):
        return self._init()

    def _decode(self, stream):
        """Per-antenna raw stream → [T, F, P] complex (or planar.PC)."""
        from clenabled_tpu.dsp import planar

        shp = (self.integration, self.num_channels, self.npol)
        if self.planar:
            if self.data_type == 5:
                z = dsp_xengine.unpack_char_planar(stream)
            elif self.data_type == 6:
                z = dsp_xengine.unpack_packed_4bit_planar(stream)
            elif isinstance(stream, planar.PC):
                z = stream
            else:
                raise TypeError("planar XEngine expects PC or raw-byte feeds")
            return planar.PC(z.re.reshape(shp), z.im.reshape(shp))
        if self.data_type == 5:  # DTYPE_BYTE / IChar
            z = dsp_xengine.unpack_char(stream)
        elif self.data_type == 6:  # DTYPE_PACKEDXY
            z = dsp_xengine.unpack_packed_4bit(stream)
        else:
            z = jnp.asarray(stream, jnp.complex64)
        return z.reshape(shp)

    def _decode_int(self, stream):
        """Per-antenna raw byte stream → (re, im) int8 [T, F, P] UNSCALED
        (the stacked engine's native ingest; scale lands on the Gram)."""
        shp = (self.integration, self.num_channels, self.npol)
        if self.data_type == 5:
            re, im = dsp_xengine.unpack_char_int8(stream)
        elif self.data_type == 6:
            re, im = dsp_xengine.unpack_packed_4bit_int8(stream)
        else:
            raise TypeError("int decode is only for IChar/PackedXY feeds")
        return re.reshape(shp), im.reshape(shp)

    def apply(self, state, inputs):
        from clenabled_tpu.dsp import planar

        if self.channel_major:
            if self.data_type in (5, 6):
                decoded = [self._decode_int(x) for x in inputs]
                parts = [(re, im) for re, im in decoded]
            else:
                decoded = [self._decode(x) for x in inputs]
                parts = [(d.re, d.im) for d in decoded]
            # [S][T,F,P] → [F, T, S·P] (stations·pols on the lanes)
            f_major = []
            for comp in (0, 1):
                s = jnp.stack([p[comp] for p in parts])     # [S,T,F,P]
                f_major.append(jnp.transpose(s, (2, 1, 0, 3)).reshape(
                    self.num_channels, self.integration, -1))
            state, (out, ready) = self._apply(state, tuple(f_major))
            return state, (), {"xcorr": {"matrix": out, "valid": ready}}

        decoded = [self._decode(x) for x in inputs]
        if self.planar:
            z = planar.PC(jnp.stack([d.re for d in decoded], axis=1),
                          jnp.stack([d.im for d in decoded], axis=1))
        else:
            z = jnp.stack(decoded, axis=1)  # [T,S,F,P]
        state, (out, ready) = self._apply(state, z)
        return state, (), {"xcorr": {"matrix": out, "valid": ready}}
