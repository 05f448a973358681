"""Shared timing/platform helpers for the benchmark CLIs.

The reference times N=200 iterations with std::chrono around each work()
call (lib/test_clenabled.cc:151-200) and lets --cpu/--gpu pick the OpenCL
device; here --cpu forces the JAX CPU backend (the hardware-free path) and
the default is whatever accelerator the session has.

Every time is a host clock around work that ends in
``jax.block_until_ready`` (JAX dispatch is asynchronous, so a time without
it measures the enqueue), taken after a warm-up call that compiles.  A
time from a ``--cpu`` run measures XLA's CPU backend, not a device.
"""

from __future__ import annotations

import statistics
import time

import jax
import numpy as np


def select_platform(args) -> None:
    """Apply --cpu before any computation happens, and turn on the
    persistent compile cache."""
    from clenabled_tpu.runtime.config import init_compile_cache

    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    init_compile_cache()


def platform_banner() -> str:
    d = jax.devices()[0]
    return f"{d.platform}:{getattr(d, 'device_kind', '?')} x{len(jax.devices())}"


def _median_time(run, rounds: int = 3) -> float:
    """Median seconds of ``rounds`` calls of run(), each ending in
    block_until_ready."""
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_fn(fn, *args, iterations: int = 200):
    """Seconds per call of fn(*args): one dispatch per call, the
    reference's per-work()-call style."""
    jax.block_until_ready(fn(*args))

    def run():
        out = None
        for _ in range(iterations):
            out = fn(*args)
        return out

    return _median_time(run) / iterations


def time_stateful(fn, state, *args, iterations: int = 200):
    """Like time_fn for (state, x) -> (state, y) streaming kernels (the
    carried state chains the calls — true steady state)."""
    jax.block_until_ready(fn(state, *args))

    def run():
        s, out = state, None
        for _ in range(iterations):
            s, out = fn(s, *args)
        return s, out

    return _median_time(run) / iterations


def rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )


def rand_float(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def report(name: str, block_size: int, secs: float, extra: str = "") -> None:
    sps = block_size / secs
    print(f"{name:<28s} {sps/1e6:>12.3f} Msps   ({secs*1e6:8.1f} us/call"
          f"{', ' + extra if extra else ''})")


def _full_sum(out):
    """Reduction folding every output leaf into a scalar so no step of a
    scanned measurement is dead code.  Sum of SQUARES, not a plain sum:
    XLA can reassociate a linear reduce through a matmul (sum(x@F) becomes
    x@sum(F), eliminating the op being measured); a quadratic cannot be
    folded.  One extra read pass; used only when the stacked-ys form would
    not fit memory."""
    import jax.numpy as jnp

    acc = jnp.float32(0)
    for leaf in jax.tree_util.tree_leaves(out):
        if not hasattr(leaf, "ravel"):
            continue
        f = jnp.abs(leaf).astype(jnp.float32)
        acc = acc + jnp.sum(f * f)
    return acc


def _out_bytes(out):
    return sum(getattr(x, "size", 0) * getattr(x, "dtype", np.float32).itemsize
               for x in jax.tree_util.tree_leaves(out)
               if hasattr(x, "size"))


_YS_BYTES_CAP = 1 << 30   # stack per-step outputs up to this much


def time_stateful_scan(fn, state, *args, reps=64):
    """Seconds per step with DEVICE-SIDE chained reps: one dispatch runs
    ``reps`` steps via lax.scan (the carried state serializes them) — what
    a Runner at the compile() default (steps_per_dispatch="auto")
    sustains, with the per-dispatch cost spread over the reps."""
    import jax.numpy as jnp

    # anti-DCE: stack per-step outputs as scan ys when they fit (each step
    # writes its own slot — exactly a real streaming run), else fold a
    # FULL sum into the carry
    probe_out = fn(state, *args)[1]
    use_ys = _out_bytes(probe_out) * reps <= _YS_BYTES_CAP

    def body(carry, _, a):
        st, acc = carry
        st2, out = fn(st, *a)
        if use_ys:
            return (st2, acc), out
        return (st2, acc + _full_sum(out)), None

    # args ride as jit parameters, not closed-over constants
    f = jax.jit(lambda st, *a: jax.lax.scan(
        lambda c, x: body(c, x, a), (st, jnp.float32(0)), None, length=reps))
    jax.block_until_ready(f(state, *args))
    return _median_time(lambda: f(state, *args)) / reps


def time_fn_scan(fn, *args, reps=64):
    """time_stateful_scan for stateless kernels.  Each step consumes a
    DISTINCT rolled copy of the inputs as scan xs: with a constant input
    XLA can unroll the scan and fuse consecutive elementwise steps into
    one pass, eliding most of the memory traffic being measured.  reps
    shrink to keep the stacked inputs+outputs within the memory cap."""
    import jax.numpy as jnp

    probe_out = fn(*args)
    per_step = _out_bytes(args) + _out_bytes(probe_out)
    if per_step:
        reps = max(4, min(reps, int(_YS_BYTES_CAP // per_step)))

    def body(acc, xs_step):
        out = fn(*xs_step)
        leaf = jax.tree_util.tree_leaves(out)[0]
        return acc + jnp.real(leaf).astype(jnp.float32).ravel()[0], out

    f = jax.jit(lambda xs: jax.lax.scan(body, jnp.float32(0), xs,
                                        length=reps))
    xs = tuple(jax.tree.map(
        lambda x: jnp.stack([jnp.roll(x, 8 * j, axis=-1)
                             for j in range(reps)]), a) for a in args)
    jax.block_until_ready(f(xs))
    return _median_time(lambda: f(xs)) / reps
