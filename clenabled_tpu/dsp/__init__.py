"""Pure-functional DSP kernel library.

Each submodule replaces one slice of the reference's generated-OpenCL kernel
layer and its in-repo CPU reference DSP library (lib/{window,firdes,fft,
fft_filter,fir_filter}.cc and the lib/cl*_impl.cc kernel builders) with
jittable JAX functions over fixed-shape sample blocks.  Host-side tap/window
design is NumPy (it runs once, at construction); everything in the streaming
hot path is jax.numpy / lax.
"""

from clenabled_tpu.dsp import (  # noqa: F401
    channelizer,
    demod,
    elementwise,
    fft,
    fft_filter,
    fir_filter,
    firdes,
    planar,
    siggen,
    window,
    xcorr,
    xengine,
)
