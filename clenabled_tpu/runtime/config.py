"""Block-size / alignment policy, debug flags and the compile cache.

The reference sizes device buffers per GR call and grows them on demand
(lib/clMathOp_impl.cc:371-373) and rounds work sizes to the kernel's preferred
workgroup multiple (lib/clMathOp_impl.cc:90-97).  Under XLA every distinct
shape is a distinct compiled program, so the policy here is the opposite:
*fix* the frame size per flowgraph (pad/bucket host input up to it) so the
whole chain compiles exactly once.
"""

from __future__ import annotations

import os

# Shape-bucketing grain: frames are padded up to a multiple of this, so a
# flowgraph compiles for few distinct shapes.
ALIGN = 1024

# Default samples per scheduler step.  8192 matches the reference's default
# correlator analysis window (grc/clenabled_clXCorrelate.block.yml).
DEFAULT_FRAME_SIZE = 8192

DEBUG = bool(int(os.environ.get("CLENABLED_TPU_DEBUG", "0")))


def round_up(n: int, multiple: int = ALIGN) -> int:
    """Round ``n`` up to a multiple (the shape-bucketing policy)."""
    return -(-n // multiple) * multiple


def validate_frame_size(n: int) -> int:
    if n <= 0:
        raise ValueError(f"frame size must be positive, got {n}")
    return n


# The persistent compile cache's default home: a fixed path in the checkout
# (listed in .gitignore).  The path is part of the cache's key, so it must
# not move between runs.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def init_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this sets nothing; otherwise the cache goes to DEFAULT_COMPILE_CACHE.
    Call it at the start of a program, before the first compilation."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE
