"""Custom user kernel — the reference's
examples/kernel1to1_multiply_const_float.cl (a user OpenCL kernel scaling
a float stream by 3.0, loaded by clKernel1To1 in float mode).  The
equivalent: a user JAX function loaded by the same (filename,
kernelFnName) pair:

    blocks.Kernel1To1(filename="examples/kernel1to1_multiply_const_float.py",
                      kernelFnName="multiply_float_const")
    python -m clenabled_tpu.tools.test_clkernel \
        --kernelfile=examples/kernel1to1_multiply_const_float.py \
        --fnname=multiply_float_const --1to1
"""

import jax.numpy as jnp


def multiply_float_const(x):
    """c[i] = a[i] * 3.0 on a float stream."""
    return (x * 3.0).astype(jnp.float32)


def main():
    import numpy as np

    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__,
                          kernelFnName="multiply_float_const")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024)
    x = np.linspace(0, 1, 1024).astype(np.float32)
    out = np.asarray(r.step(x)[tap])
    print("multiply_float_const output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
