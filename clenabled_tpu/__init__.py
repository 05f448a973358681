"""clenabled_tpu — a streaming SDR block library on JAX/XLA.

A framework with the capabilities of gr-clenabled (ghostop14's
OpenCL-accelerated GNU Radio blocks), built on JAX/XLA:

- ``runtime``   — device/mesh core, dtype registry, block-size policy
                  (the role of the reference's GRCLBase runtime,
                  /root/reference/lib/GRCLBase.cpp, reimagined as one shared
                  mesh instead of per-block OpenCL contexts).
- ``dsp``       — pure-functional kernel library: windows, firdes designers,
                  FFT with gr-clenabled's shift/window semantics, overlap-add
                  fast convolution, FIR, polyphase channelizer, demodulators,
                  correlators and the X-Engine — each a jittable function over
                  fixed-shape sample blocks.
- ``streaming`` — the block/flowgraph runtime: explicit carried state
                  (filter tails, loop phase, integration accumulators) in a
                  functional scheduler.
- ``sharding``  — multi-chip layer: shard_map over a Mesh, ppermute halo
                  exchange for filter overlap, all_to_all for the X-Engine.
- ``blocks``    — user-facing named blocks mirroring the reference's API
                  surface (clFFT, clFilter, clXEngine, ...).
- ``tools``     — CLI benchmark/info tools mirroring clview/test-clenabled/...
"""

__version__ = "0.1.0"

from clenabled_tpu.runtime import dtypes  # noqa: F401


def exact_f32():
    """Context manager forcing exact-f32 matmul sums.

    Under JAX's default matmul precision a GPU may run float32 matmuls in
    TF32 (about three decimal digits); the reference's kernels keep f32
    multiply-adds.  Wrap accuracy-critical calls in this context to get
    true f32 sums::

        with clenabled_tpu.exact_f32():
            out = my_jitted_pipeline(x)

    The matmul precision is part of jax.jit's cache key and binds at
    trace/dispatch time, so the context must wrap EVERY call of a jitted
    function, not just the first — a later call outside the context
    silently retraces (or cache-switches) back to the default-precision
    executable.  ``streaming.Runner.step`` does exactly this when a
    precision is configured (``Flowgraph.compile(precision=...)``).
    """
    import jax

    return jax.default_matmul_precision("float32")
