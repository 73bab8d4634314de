"""Exact emulation of the int16 fixed-point arithmetic the AVX2 kernels use.

Copied from ``fdreadoutlibs_tpu/ops/fixedpoint.py:1-196``: the int32
emulation ``I32Fx``, the helpers it calls, and the native int16 mode
``I16Fx`` (the plain version of K2b), whose casts are torch's ``.to``.

The reference relies on quirky-but-load-bearing int16 semantics; we compute
in int32 and reproduce them bit-exactly:

* ``mulhrs`` — ``_mm256_mulhrs_epi16``: ((a*b) >> 14 + 1) >> 1, the rounding
  high-multiply behind the "divide by constant" trick
  (wibeth/tpg/UtilsAVX2.hpp:77-81: div(a, b) = mulhrs(a, 32768/b));
* ``mullo16`` — ``_mm256_mullo_epi16``: wrapping int16 product;
* ``wrap_i16`` / ``sat_i16`` — int16 wraparound / clamp.

The I32Fx functions only use ``+ - * >> & |``, so they run unchanged on
numpy arrays and torch int32 tensors; I16Fx runs on torch int16 tensors.
"""

from __future__ import annotations

import torch

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


class I16Fx:
    """Fixed-point helper namespace: native int16 tensors — the tensor's
    own wraparound replaces the emulation (``TorchXP(dtype=torch.int16)``).

    Bit-identical to I32Fx wherever inputs are int16-range by construction
    (every carried state value; pedestal-subtracted 14-bit samples).
    """

    dtype_name = "int16"

    @staticmethod
    def make(xp):
        class _F:
            dtype = xp.int16
            one = xp.int16(1)
            zero = xp.int16(0)
            cast_in = staticmethod(lambda x: x.to(torch.int16))
            wrap = staticmethod(lambda x: x)              # int16 wraps natively
            mullo = staticmethod(lambda a, b: a * b)
            sub16 = staticmethod(lambda a, b: a - b)

            @staticmethod
            def div10(a):
                # mulhrs needs the 32-bit intermediate
                a32 = a.to(torch.int32)
                return (((a32 * 3276 >> 14) + 1) >> 1).to(torch.int16)

            @staticmethod
            def rs_div10(a):
                # native int16 arithmetic already wrapped the sum; the
                # mulhrs result (+-3276) casts back exactly
                a32 = a.to(torch.int32)
                return ((a32 * 3276 + 16384) >> 15).to(torch.int16)

            @staticmethod
            def add_clamp(a, b, cap, floor=None):
                # widen for the clamps (naive int32-accumulate semantics;
                # floor = adds_epi16 negative saturation, see I32Fx)
                s = xp.minimum(a.to(torch.int32) + b.to(torch.int32), cap)
                if floor is not None:
                    s = xp.maximum(s, floor)
                return s.to(torch.int16)

            widen = staticmethod(lambda x: x.to(torch.int32))

            # compare-and-select, as the JAX package's (its TPU lowering has
            # no int16 min/max)
            @staticmethod
            def clip(x, lo, hi):
                x = xp.where(x > hi, hi, x)
                return xp.where(x < lo, lo, x)

            @staticmethod
            def minimum(a, b):
                return xp.where(a > b, b, a)
        return _F
