"""Signal source — sin/cos generator with carried phase.

Replaces clSignalSource (lib/clSignalSource_impl.cc).  The reference kernel
computes ``phase + inc*index`` per work item (fp64 on capable devices,
:113-237) while the host advances and wraps the phase once per buffer
(step(), :280-303).  fp64 is slow on the device, so precision comes from a
different trick: the per-index phase ramp ``(inc*index) mod 2π`` is
precomputed once on the host in float64 and baked as a float32 constant, so
in-frame error stays at float32 epsilon instead of growing with index.

Waveform codes: SIGSOURCE_COS=1, SIGSOURCE_SIN=2
(lib/clSignalSource_impl.h:27-28).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

SIGSOURCE_COS = 1
SIGSOURCE_SIN = 2

TWO_PI = 2.0 * math.pi


class SigGenState(NamedTuple):
    """Carried phase (radians, wrapped to ±2π) — the analogue of the
    reference's d_double_angle_pos host state."""
    phase: jax.Array  # f32 scalar


def make_signal_source(sampling_freq: float, waveform: int, frequency: float,
                       amplitude: float, frame_size: int,
                       dtype=jnp.complex64, planar: bool = False):
    """Build (init_state, generate) for a fixed-shape frame generator.

    generate(state) -> (state', frame) where frame is [frame_size] of
    ``dtype`` (complex64 → cos + j·sin; float32/int32 → selected waveform).
    With ``planar=True`` the complex frame is a planar.PC(cos, sin) pair.
    """
    angle_rate = TWO_PI * frequency / sampling_freq
    # per-index ramp, wrapped in fp64 host-side, then cast
    ramp = np.mod(angle_rate * np.arange(frame_size, dtype=np.float64), TWO_PI)
    ramp = jnp.asarray(ramp, jnp.float32)
    frame_advance = jnp.float32(math.fmod(angle_rate * frame_size, TWO_PI))
    ampl = jnp.float32(amplitude)

    def init_state() -> SigGenState:
        return SigGenState(phase=jnp.float32(0.0))

    @jax.jit
    def generate(state: SigGenState):
        angles = state.phase + ramp
        if planar:
            from clenabled_tpu.dsp import planar as pl_mod

            frame = pl_mod.PC(ampl * jnp.cos(angles), ampl * jnp.sin(angles))
        elif dtype == jnp.complex64:
            frame = (ampl * jnp.cos(angles) + 1j * (ampl * jnp.sin(angles))
                     ).astype(jnp.complex64)
        else:
            wave = jnp.cos(angles) if waveform == SIGSOURCE_COS else jnp.sin(angles)
            frame = (ampl * wave).astype(dtype)
        new_phase = state.phase + frame_advance
        # wrap to ±2π like the reference's step() loop (:286-296)
        new_phase = new_phase - jnp.where(new_phase > TWO_PI, TWO_PI, 0.0)
        new_phase = new_phase + jnp.where(new_phase < -TWO_PI, TWO_PI, 0.0)
        return SigGenState(phase=new_phase), frame

    return init_state, generate
