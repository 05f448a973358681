"""Elementwise math and conversion kernels.

Replaces the reference's generated one-work-item-per-sample OpenCL kernels
(clMathOp, clMathConst, clComplexToMag/Arg/MagPhase, clMagPhaseToComplex,
clLog, clSNR — lib/cl*_impl.cc) with jnp expressions XLA fuses.
Op codes match include/clenabled/clMathOpTypes.h:11-20.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

# Op codes, parity with include/clenabled/clMathOpTypes.h
MATHOP_MULTIPLY = 1
MATHOP_ADD = 2
MATHOP_SUBTRACT = 3
MATHOP_COMPLEX_CONJUGATE = 4
MATHOP_MULTIPLY_CONJUGATE = 5
MATHOP_LOG10 = 6
MATHOP_LOG = 7
MATHOP_SNR_HELPER = 8
MATHOP_EMPTY = 255        # no-op kernels used for baseline timing
MATHOP_EMPTY_W_COPY = 254


def _is_pc(x) -> bool:
    """Planar-complex (dsp.planar.PC) value?  Every elementwise op also
    accepts planar pairs so the whole block layer can run complex-free."""
    from clenabled_tpu.dsp import planar

    return isinstance(x, planar.PC)


def math_op(op: int, a, b=None):
    """Two-input (or one-input for conjugate/log) math op by code
    (lib/clMathOp_impl.cc:104-238 kernel codegen)."""
    if _is_pc(a):
        from clenabled_tpu.dsp import planar

        if op == MATHOP_MULTIPLY:
            return planar.mul(a, b)
        if op == MATHOP_ADD:
            return planar.add(a, b)
        if op == MATHOP_SUBTRACT:
            return planar.sub(a, b)
        if op == MATHOP_COMPLEX_CONJUGATE:
            return planar.conj(a)
        if op == MATHOP_MULTIPLY_CONJUGATE:
            return planar.mul_conj(a, b)
        if op in (MATHOP_EMPTY, MATHOP_EMPTY_W_COPY):
            return a
        raise ValueError(f"op {op} undefined for planar input")
    if op == MATHOP_MULTIPLY:
        return a * b
    if op == MATHOP_ADD:
        return a + b
    if op == MATHOP_SUBTRACT:
        return a - b
    if op == MATHOP_COMPLEX_CONJUGATE:
        return jnp.conj(a)
    if op == MATHOP_MULTIPLY_CONJUGATE:
        return a * jnp.conj(b)
    if op == MATHOP_LOG10:
        return jnp.log10(a)
    if op == MATHOP_LOG:
        return jnp.log(a)
    if op == MATHOP_SNR_HELPER:
        return snr_helper(a, b)
    if op == MATHOP_EMPTY:
        return a
    if op == MATHOP_EMPTY_W_COPY:
        return a
    raise ValueError(f"unknown math op code {op}")


def multiply(a, b):
    return math_op(MATHOP_MULTIPLY, a, b)


def add(a, b):
    return math_op(MATHOP_ADD, a, b)


def subtract(a, b):
    return math_op(MATHOP_SUBTRACT, a, b)


def multiply_conjugate(a, b):
    """a * conj(b) (clMultiplyConjugate)."""
    return math_op(MATHOP_MULTIPLY_CONJUGATE, a, b)


def complex_conjugate(a):
    return math_op(MATHOP_COMPLEX_CONJUGATE, a)


def multiply_const(a, k):
    """Multiply by scalar.  The reference's complex variant multiplies both
    components by a real float scalar (lib/clMathConst_impl.cc:100-190), so
    a float ``k`` against a complex stream scales it — same here by
    broadcasting."""
    if _is_pc(a):
        from clenabled_tpu.dsp import planar

        return planar.scale(a, k)
    return a * k


def add_const(a, k):
    if _is_pc(a):
        from clenabled_tpu.dsp import planar

        kr = getattr(k, "real", k)
        ki = getattr(k, "imag", 0.0)
        return planar.PC(a.re + kr, a.im + ki)
    return a + k


def complex_to_mag(a):
    """sqrt(re²+im²) (lib/clComplexToMag_impl.cc:132-148)."""
    if _is_pc(a):
        from clenabled_tpu.dsp import planar

        return planar.pabs(a)
    return jnp.abs(a).astype(jnp.float32)


def complex_to_arg(a):
    """atan2(im, re) (lib/clComplexToArg_impl.cc:132-151)."""
    if _is_pc(a):
        return jnp.arctan2(a.im, a.re).astype(jnp.float32)
    return jnp.angle(a).astype(jnp.float32)


def complex_to_mag_phase(a):
    """(mag, phase) in one pass (lib/clComplexToMagPhase_impl.cc:143-165)."""
    return complex_to_mag(a), complex_to_arg(a)


def mag_phase_to_complex(mag, phase, planar_out: bool = False):
    """mag·(cos φ + j sin φ) (lib/clMagPhaseToComplex_impl.cc:162-192)."""
    mag = jnp.asarray(mag, jnp.float32)
    phase = jnp.asarray(phase, jnp.float32)
    if planar_out:
        from clenabled_tpu.dsp import planar

        return planar.PC(mag * jnp.cos(phase), mag * jnp.sin(phase))
    return (mag * jnp.cos(phase) + 1j * mag * jnp.sin(phase)).astype(jnp.complex64)


_LOG2_10_INV = 1.0 / math.log2(10.0)


def log10(a, n: float = 1.0, k: float = 0.0):
    """n·log10(a)+k, computed as (n/log2 10)·log2(a)+k exactly like the
    reference's log2-based kernel (lib/clLog_impl.cc:101-148)."""
    factor = jnp.float32(n * _LOG2_10_INV)
    return factor * jnp.log2(jnp.asarray(a, jnp.float32)) + jnp.float32(k)


def log(a):
    """Natural log (clLog's MATHOP_LOG variant)."""
    return jnp.log(jnp.asarray(a, jnp.float32))


def snr_helper(a, b, n: float = 1.0, k: float = 0.0):
    """|n·log10(a/b)+k| — fused divide→log→abs (lib/clSNR_impl.cc:99-113)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return jnp.abs(jnp.float32(n) * jnp.log10(a / b) + jnp.float32(k))


def char_to_complex(a):
    """Interleaved signed-byte I/Q → complex64 scaled by 1/127
    (lib/clXEngine_impl.cc CharToComplex, byte path)."""
    a = jnp.asarray(a, jnp.int8).astype(jnp.float32) * jnp.float32(1.0 / 127.0)
    pairs = a.reshape(a.shape[:-1] + (-1, 2))
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(jnp.complex64)
