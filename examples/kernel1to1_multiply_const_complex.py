"""Custom user kernel — the reference's
examples/kernel1to1_multiply_const_complex.cl (a user OpenCL kernel
scaling a complex stream by 3.0, loaded by clKernel1To1).  Here the
equivalent is this user JAX function, loaded by Kernel1To1 via the same
(filename, kernelFnName) pair:

    blocks.Kernel1To1(filename="examples/kernel1to1_multiply_const_complex.py",
                      kernelFnName="multiply_const_complex")
    python -m clenabled_tpu.tools.test_clkernel \
        --kernelfile=examples/kernel1to1_multiply_const_complex.py \
        --fnname=multiply_const_complex --complex --1to1
"""

import jax.numpy as jnp


def multiply_const_complex(x):
    """c[i] = a[i] * 3.0 on a complex stream — mirrors the .cl example's
    per-work-item scale of the (real, imag) struct fields."""
    return (x * 3.0).astype(jnp.complex64)


def main():
    import numpy as np

    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__,
                          kernelFnName="multiply_const_complex")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024)
    x = (np.linspace(0, 1, 1024) + 1j * np.linspace(1, 0, 1024)
         ).astype(np.complex64)
    out = np.asarray(r.step(x)[tap])
    print("multiply_const_complex output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
