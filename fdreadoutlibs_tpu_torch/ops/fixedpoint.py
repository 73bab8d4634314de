"""Exact emulation of the int16 fixed-point arithmetic the AVX2 kernels use.

Copied from ``fdreadoutlibs_tpu/ops/fixedpoint.py:1-139`` (the int32
emulation ``I32Fx`` and the helpers it calls); the native int16 mode
``I16Fx`` (:142-196) is K2b of ROADMAP.md and is not carried yet.

The reference relies on quirky-but-load-bearing int16 semantics; we compute
in int32 and reproduce them bit-exactly:

* ``mulhrs`` — ``_mm256_mulhrs_epi16``: ((a*b) >> 14 + 1) >> 1, the rounding
  high-multiply behind the "divide by constant" trick
  (wibeth/tpg/UtilsAVX2.hpp:77-81: div(a, b) = mulhrs(a, 32768/b));
* ``mullo16`` — ``_mm256_mullo_epi16``: wrapping int16 product;
* ``wrap_i16`` / ``sat_i16`` — int16 wraparound / clamp.

All functions only use ``+ - * >> & |``, so they run unchanged on numpy
arrays and torch int32 tensors.
"""

from __future__ import annotations

INT16_MAX = 32767
INT16_MIN = -32768


def wrap_i16(x):
    """Reinterpret an int32 value as wrapped int16 (two's complement).

    (x << 16) >> 16 — left shift wraps mod 2^32 and the arithmetic right
    shift sign-extends the low 16 bits.
    """
    if isinstance(x, int):
        return ((x + 32768) & 0xFFFF) - 32768
    return (x << 16) >> 16


def sat_i16(x):
    """Clamp to int16 range (saturating)."""
    return x.clip(INT16_MIN, INT16_MAX) if hasattr(x, "clip") else max(INT16_MIN, min(INT16_MAX, x))


def mullo16_i16(a, b):
    """_mm256_mullo_epi16 (wrapping low-half int16 product) for inputs
    already in int16 range."""
    return wrap_i16(a * b)


def mulhrs16_i16(a, b):
    """_mm256_mulhrs_epi16 for inputs already in int16 range:
    round((a*b) / 2^15) computed as (((a*b)>>14)+1)>>1."""
    return wrap_i16(((a * b >> 14) + 1) >> 1)


def rs_div10_unwrapped(sum32):
    """div16_const(wrap_i16(sum32), 10) with deferred wrapping — the RS
    update's whole tail in minimal depth.

    * the adds/multiplies feeding ``sum32`` are int16 lane ops upstream, so
      any int32 value congruent mod 2^16 gives the same wrap;
    * ``((p >> 14) + 1) >> 1  ==  (p + 16384) >> 15`` for all int32 p;
    * the mulhrs result for multiplier 3276 is in [-3276, 3276], so the
      final int16 wrap is a no-op and is dropped.
    """
    a = wrap_i16(sum32)
    return (a * 3276 + 16384) >> 15


def div16_const_i16(a, b: int):
    """_mm256_div_epi16(a, b) = mulhrs(a, 32768/b) for `a` already in int16
    range (UtilsAVX2.hpp:77-81, including its rounding)."""
    return mulhrs16_i16(a, 32768 // b)


class I32Fx:
    """Fixed-point helper namespace: int32 arrays holding int16-range
    values with explicit wrap emulation."""

    dtype_name = "int32"

    @staticmethod
    def make(xp):
        class _F:
            dtype = xp.int32
            one = xp.int32(1)
            zero = xp.int32(0)
            cast_in = staticmethod(lambda x: x.astype(xp.int32))
            wrap = staticmethod(wrap_i16)
            mullo = staticmethod(mullo16_i16)
            div10 = staticmethod(lambda a: div16_const_i16(a, 10))
            rs_div10 = staticmethod(rs_div10_unwrapped)
            sub16 = staticmethod(lambda a, b: wrap_i16(a - b))

            @staticmethod
            def add_clamp(a, b, cap, floor=None):
                # floor=INT16_MIN reproduces _mm256_adds_epi16's negative
                # saturation (the production RS/FIR kernels); floor=None
                # is the top-only clamp of the naive oracle's int32
                # accumulate (ProcessNaive.hpp:96-99), enough when the
                # accumulated terms are provably non-negative
                s = xp.minimum(a + b, cap)
                return s if floor is None else xp.maximum(s, floor)
            widen = staticmethod(lambda x: x)
            clip = staticmethod(lambda x, lo, hi: xp.clip(x, lo, hi))
            minimum = staticmethod(xp.minimum)
        return _F
