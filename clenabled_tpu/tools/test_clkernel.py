"""Custom-kernel harness — the reference's test-clkernel
(lib/test-clkernel.cc): load a user kernel file + function name, compile and
time it.  Here the kernel file is a Python module defining a JAX
function; --1to1/--2to1 and dtype flags mirror the reference CLI."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="user kernel benchmark")
    ap.add_argument("--kernelfile", required=True)
    ap.add_argument("--fnname", required=True)
    ap.add_argument("--2to1", dest="two_to_one", action="store_true")
    ap.add_argument("--1to1", dest="one_to_one", action="store_true")
    ap.add_argument("--complex", dest="dtype_complex", action="store_true")
    ap.add_argument("--float", dest="dtype_float", action="store_true")
    ap.add_argument("--int", dest="dtype_int", action="store_true")
    ap.add_argument("blocksize", nargs="?", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iterations", type=int, default=200)
    args = ap.parse_args()

    from clenabled_tpu.tools import _timing as T
    T.select_platform(args)

    import jax
    import numpy as np

    from clenabled_tpu.blocks.core import _load_fn_from_file

    fn = jax.jit(_load_fn_from_file(args.kernelfile, args.fnname))
    n = args.blocksize
    if args.dtype_float:
        mk = lambda s: T.rand_float(n, s)
    elif args.dtype_int:
        mk = lambda s: np.arange(n, dtype=np.int32)
    else:
        mk = lambda s: T.rand_complex(n, s)

    inputs = [jax.device_put(mk(i)) for i in
              range(2 if args.two_to_one else 1)]
    secs = T.time_fn(fn, *inputs, iterations=args.iterations)
    T.report(f"{args.fnname} ({args.kernelfile})", n, secs)


if __name__ == "__main__":
    main()
