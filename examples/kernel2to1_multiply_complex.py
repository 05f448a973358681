"""Custom 2-input user kernel — the reference's
examples/kernel2to1_multiply_complex.cl (a user OpenCL kernel computing
c = a·b per sample, loaded by clKernel2To1).  The equivalent here is
a user JAX function of two streams in a Python file, loaded by Kernel2To1
via the same (filename, kernelFnName) pair, or passed directly as a
callable.

This file doubles as the loadable kernel module:

    blocks.Kernel2To1(filename="examples/kernel2to1_multiply_complex.py",
                      kernelFnName="multiply_complex")
    python -m clenabled_tpu.tools.test_clkernel \
        --kernelfile=examples/kernel2to1_multiply_complex.py \
        --fnname=multiply_complex --2to1 --complex
"""

import jax.numpy as jnp


def multiply_complex(a, b):
    """Per-sample complex product — mirrors the .cl kernel's
    (a_r·b_r − a_i·b_i) + j(a_r·b_i + a_i·b_r)."""
    return (a * b).astype(jnp.complex64)


def main():
    import numpy as np

    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    k = blocks.Kernel2To1(filename=__file__, kernelFnName="multiply_complex")
    g = Flowgraph()
    g.external_input(k, 0)
    g.external_input(k, 1)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024)
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    b = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    out = np.asarray(r.step(a, b)[tap])
    np.testing.assert_allclose(out, a * b, rtol=1e-5)
    print("custom 2:1 kernel ok; output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
