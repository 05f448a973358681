"""Direct-form FIR filtering with decimation.

Replaces the reference's generated ``td_FIR_complex`` /
``td_FIR_complex_complex`` time-domain kernels (lib/clFilter_impl.cc:152-243,
lib/clComplexFilter_impl.cc:796-830) and the type-specialized CPU
``fir_filter_*`` classes (lib/fir_filter.h:32-192).

Convention (GNU Radio): the caller supplies ``ntaps-1`` history samples at
the FRONT of the input (the reference gets these via ``set_history``,
lib/clFilter_impl.cc:78), and

    y[n] = sum_j taps[j] * x[n + ntaps-1 - j]          (a "valid" convolution)
    out[m] = y[m * decimation]

Complex data with real or complex taps decomposes into real 1-D convolutions
that XLA lowers to its convolution kernels; there is no scalar tap loop.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def _conv_valid_real(x, taps):
    """Real 'valid' convolution via conv_general_dilated (correlation with
    reversed taps).  x: [L] f32, taps: [K] f32 -> [L-K+1] f32."""
    lhs = x[None, None, :]                       # [N=1, C=1, W]
    rhs = taps[::-1][None, None, :]              # [O=1, I=1, W]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        preferred_element_type=jnp.float32,
    )
    return out[0, 0]


def fir_filter(x, taps, decimation: int = 1):
    """Filter one frame.

    Args:
      x: [ntaps-1 + n] samples (history at the front); float32 or complex64.
      taps: [ntaps] float32 or complex64.
      decimation: keep every decimation-th output.

    Returns: [n // decimation] filtered samples (complex64 if either input
      is complex, else float32).  ``n`` must be a multiple of ``decimation``.
    """
    x = jnp.asarray(x)
    taps = jnp.asarray(taps)
    n = x.shape[-1] - (taps.shape[-1] - 1)
    if n <= 0:
        raise ValueError("input shorter than filter history")
    if n % decimation:
        raise ValueError(f"frame length {n} not a multiple of decimation {decimation}")

    x_c = jnp.issubdtype(x.dtype, jnp.complexfloating)
    t_c = jnp.issubdtype(taps.dtype, jnp.complexfloating)

    if not x_c and not t_c:
        y = _conv_valid_real(x.astype(jnp.float32), taps.astype(jnp.float32))
    elif x_c and not t_c:
        t = taps.astype(jnp.float32)
        y = (_conv_valid_real(x.real.astype(jnp.float32), t)
             + 1j * _conv_valid_real(x.imag.astype(jnp.float32), t)
             ).astype(jnp.complex64)
    elif not x_c and t_c:
        xr = x.astype(jnp.float32)
        y = (_conv_valid_real(xr, taps.real.astype(jnp.float32))
             + 1j * _conv_valid_real(xr, taps.imag.astype(jnp.float32))
             ).astype(jnp.complex64)
    else:
        xr = x.real.astype(jnp.float32)
        xi = x.imag.astype(jnp.float32)
        tr = taps.real.astype(jnp.float32)
        ti = taps.imag.astype(jnp.float32)
        y = ((_conv_valid_real(xr, tr) - _conv_valid_real(xi, ti))
             + 1j * (_conv_valid_real(xr, ti) + _conv_valid_real(xi, tr))
             ).astype(jnp.complex64)

    if decimation > 1:
        y = y[::decimation]
    return y


def fir_filter_planar(x, taps, decimation: int = 1):
    """Planar fir_filter: x is a planar.PC with history at the front; taps
    real or complex (numpy)."""
    import numpy as np

    from clenabled_tpu.dsp import planar

    taps = np.asarray(taps)
    n = x.re.shape[-1] - (taps.shape[-1] - 1)
    if n % decimation:
        raise ValueError(f"frame length {n} not a multiple of decimation")
    if np.iscomplexobj(taps):
        tr = jnp.asarray(taps.real.copy(), jnp.float32)
        ti = jnp.asarray(taps.imag.copy(), jnp.float32)
        yr = _conv_valid_real(x.re, tr) - _conv_valid_real(x.im, ti)
        yi = _conv_valid_real(x.re, ti) + _conv_valid_real(x.im, tr)
    else:
        t = jnp.asarray(taps, jnp.float32)
        yr = _conv_valid_real(x.re, t)
        yi = _conv_valid_real(x.im, t)
    if decimation > 1:
        yr, yi = yr[::decimation], yi[::decimation]
    return planar.PC(yr, yi)


def make_fir_filter_planar_xla(taps, decimation: int = 1):
    """Streaming planar FIR: (init_state, apply) with
    apply((hist_r, hist_i), frame: planar.PC) -> (state, planar.PC)."""
    import numpy as np

    from clenabled_tpu.dsp import planar

    taps_np = np.asarray(taps)
    ntaps = int(taps_np.shape[-1])

    def init_state(frame_size: int | None = None):
        del frame_size
        z = jnp.zeros((ntaps - 1,), jnp.float32)
        return (z, jnp.zeros_like(z))

    @jax.jit
    def apply(state, frame):
        fr = jnp.concatenate([state[0], frame.re])
        fi = jnp.concatenate([state[1], frame.im])
        y = fir_filter_planar(planar.PC(fr, fi), taps_np, decimation)
        return (fr[fr.shape[-1] - (ntaps - 1):],
                fi[fi.shape[-1] - (ntaps - 1):]), y

    return init_state, apply


def fir_filter_scc(x, taps, decimation: int = 1):
    """short→complex FIR (reference fir_filter_scc, lib/fir_filter.h:160):
    int16 samples widened to float32, complex taps, complex64 output.

    x: [ntaps-1 + n] int16 (history at the front); taps: [ntaps] complex64.
    """
    x = jnp.asarray(x, jnp.int16).astype(jnp.float32)
    taps = jnp.asarray(taps, jnp.complex64)
    return fir_filter(x, taps, decimation)


def fir_filter_fsf(x, taps, decimation: int = 1):
    """float→short FIR (reference fir_filter_fsf, lib/fir_filter.h:192):
    float32 dot product, output cast to int16 with C truncation-toward-zero
    semantics (volk_32f_x2_dot_prod_16i's ``(int16_t)dotProduct``)."""
    x = jnp.asarray(x, jnp.float32)
    taps = jnp.asarray(taps, jnp.float32)
    y = fir_filter(x, taps, decimation)
    return y.astype(jnp.int16)


def make_fir_filter_typed(taps, decimation: int = 1,
                          in_dtype=jnp.complex64, out_dtype=None):
    """Streaming FIR with explicit stream dtypes — covers the reference's
    six CPU variants fff/ccf/fcc/ccc/scc/fsf (lib/fir_filter.h:32-192).

    The carried history keeps the INPUT dtype (int16 history costs half a
    float32 one); widening happens per frame on device.  out_dtype=jnp.int16
    reproduces fsf's truncation-toward-zero narrowing."""
    taps = jnp.asarray(taps)
    ntaps = int(taps.shape[-1])
    in_dtype = jnp.dtype(in_dtype)

    def init_state(frame_size: int | None = None):
        del frame_size
        return jnp.zeros((ntaps - 1,), dtype=in_dtype)

    @jax.jit
    def apply(history, frame):
        frame = jnp.asarray(frame, in_dtype)
        full = jnp.concatenate([history, frame], axis=-1)
        xf = full
        if in_dtype == jnp.int16:
            xf = full.astype(jnp.float32)
        out = fir_filter(xf, taps, decimation)
        if out_dtype is not None:
            out = out.astype(out_dtype)
        new_history = full[..., full.shape[-1] - (ntaps - 1):]
        return new_history, out

    return init_state, apply


def make_fir_filter(taps, decimation: int = 1, complex_input: bool = True):
    """Streaming form: (init_state, apply) where state is the carried
    ``ntaps-1``-sample history (the role of GR's set_history).

    apply(history, frame) -> (new_history, out); frame length must be a
    multiple of ``decimation`` and should stay fixed for a single jit cache
    entry.
    """
    taps = jnp.asarray(taps)
    ntaps = int(taps.shape[-1])
    hist_dtype = jnp.complex64 if complex_input else jnp.float32

    def init_state(frame_size: int | None = None):
        del frame_size
        return jnp.zeros((ntaps - 1,), dtype=hist_dtype)

    @jax.jit
    def apply(history, frame):
        frame = jnp.asarray(frame, hist_dtype)
        full = jnp.concatenate([history, frame], axis=-1)
        out = fir_filter(full, taps, decimation)
        new_history = full[..., full.shape[-1] - (ntaps - 1):]
        return new_history, out

    return init_state, apply


# ---------------------------------------------------------------------------
# Interpolating FIR (polyphase) — GR's interp_fir_filter contract, which the
# reference lacks entirely (its blocks only decimate); added so the streaming
# scheduler covers GR's full forecast contract (interpolators + decimators).
# ---------------------------------------------------------------------------


def _branch_taps(taps, interp: int):
    """taps [T] → branch matrix [L, Kb] with h_p[j] = taps[p + L·j]."""
    import numpy as np

    taps = np.asarray(taps, np.float32)
    kb = -(-len(taps) // interp)
    padded = np.zeros(kb * interp, np.float32)
    padded[: len(taps)] = taps
    return padded.reshape(kb, interp).T.copy()   # [L, Kb]


def interp_fir_filter(x, taps, interp: int):
    """Polyphase interpolating FIR over one real frame.

    Input carries Kb−1 = ceil(T/L)−1 history samples at the front;
    y[i·L + p] = Σ_j taps[p + L·j] · x[i + Kb−1 − j]  (the polyphase
    decomposition of zero-stuff-by-L → FIR(taps)).
    x: [Kb−1 + n] float32 → [n·L] float32.
    """
    hb = _branch_taps(taps, interp)              # [L, Kb]
    lhs = jnp.asarray(x, jnp.float32)[None, None, :]
    rhs = jnp.asarray(hb[:, ::-1])[:, None, :]   # [O=L, I=1, Kb]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        preferred_element_type=jnp.float32,
    )[0]                                         # [L, n]
    return out.T.reshape(-1)                     # y[i·L + p] = out[p, i]


def make_interp_fir_filter_planar(taps, interp: int):
    """Streaming planar interpolating FIR: (init_state, apply) with
    apply((hr, hi), frame: planar.PC[n]) -> (state, planar.PC[n·L]);
    state = Kb−1 input samples per component."""
    import numpy as np

    from clenabled_tpu.dsp import planar

    taps_np = np.asarray(taps, np.float32)
    kb = -(-len(taps_np) // interp)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = jnp.zeros((kb - 1,), jnp.float32)
        return (z, jnp.zeros_like(z))

    @jax.jit
    def apply(state, frame):
        fr = jnp.concatenate([state[0], frame.re])
        fi = jnp.concatenate([state[1], frame.im])
        yr = interp_fir_filter(fr, taps_np, interp)
        yi = interp_fir_filter(fi, taps_np, interp)
        k = fr.shape[-1] - (kb - 1)
        return (fr[k:], fi[k:]), planar.PC(yr, yi)

    return init_state, apply


def make_interp_fir_filter(taps, interp: int):
    """Complex-stream variant (float taps — GR interp_fir_filter_ccf)."""
    import numpy as np

    taps_np = np.asarray(taps, np.float32)
    kb = -(-len(taps_np) // interp)

    def init_state(frame_size: int | None = None):
        del frame_size
        return jnp.zeros((kb - 1,), jnp.complex64)

    @jax.jit
    def apply(state, frame):
        full = jnp.concatenate([state, jnp.asarray(frame, jnp.complex64)])
        yr = interp_fir_filter(full.real, taps_np, interp)
        yi = interp_fir_filter(full.imag, taps_np, interp)
        k = full.shape[-1] - (kb - 1)
        return full[k:], (yr + 1j * yi).astype(jnp.complex64)

    return init_state, apply
