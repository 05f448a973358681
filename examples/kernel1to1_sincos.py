"""Custom user kernel — the reference's examples/kernel1to1_sincos.cl
(a user-supplied OpenCL kernel file loaded by clKernel1To1).  Here the
equivalent is a user JAX function in a Python file, loaded by Kernel1To1 via
the same (filename, kernelFnName) pair, or passed directly as a callable.

This file doubles as the loadable kernel module:

    blocks.Kernel1To1(filename="examples/kernel1to1_sincos.py",
                      kernelFnName="sincos")
    python -m clenabled_tpu.tools.test_clkernel \
        --kernelfile=examples/kernel1to1_sincos.py --fnname=sincos --complex
"""

import jax.numpy as jnp


def sincos(x):
    """Per-sample sin(re) + j·cos(im) — mirrors the .cl example's intent."""
    return (jnp.sin(x.real) + 1j * jnp.cos(x.imag)).astype(jnp.complex64)


def main():
    import numpy as np

    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__, kernelFnName="sincos")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024)
    x = (np.linspace(0, np.pi, 1024) + 1j * np.linspace(0, np.pi, 1024)
         ).astype(np.complex64)
    out = np.asarray(r.step(x)[tap])
    print("custom kernel output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
