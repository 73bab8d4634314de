"""The SWTPG per-tick update — one definition for the port's plain version
and oracle.

Copied from ``fdreadoutlibs_tpu/ops/step.py:1-200``, unchanged in its
arithmetic; the float running sum (``rs_float=True``, :97-104, :131-133)
converts with torch's ``.to`` (numpy's ``.astype`` for the oracle).
``tests/test_torch_fir2.py`` holds this copy to the JAX package's, so the
two packages keep one tick semantics.

This is the reference's hot inner loop (ProcessAVX2.hpp:70-209 /
ProcessAbsRSAVX2.hpp:98-305 / ProcessStandardRSAVX2.hpp and the naive
oracles ProcessNaive.hpp:72-130, ProcessNaiveRS.hpp:66-161) expressed once as
a pure function over (..., C) integer arrays of any namespace ``xp``
(numpy, or ``ops/xp.TorchXP`` over torch tensors).

All values are int32 holding int16-range quantities; int16 wrap/saturate
points follow the AVX2 kernels via :mod:`fixedpoint`.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Algorithm, TPGConfig
from .fixedpoint import I32Fx

INT16_MAX = 32767


def _astype(x, dtype):
    """``x`` (a torch tensor or a numpy array) as ``dtype``, given as a
    tensor or array of that dtype or as "int32"/"float32"."""
    if isinstance(dtype, str):
        dtype = getattr(torch if isinstance(x, torch.Tensor) else np, dtype)
    else:
        dtype = dtype.dtype
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


def _round_half_away(v, xp):
    """std::round: half away from zero (ProcessNaiveRS.hpp:103), as
    trunc(v + copysign(0.5, v)) in float32 — not a round-half-even."""
    return _astype(xp.trunc(v + xp.copysign(0.5, v)), "int32")


def frugal_update(m, s, acc, limit: int, xp, mask=None, fx=None,
                  acc_bias: int = 0):
    """Frugal-streaming running-median update (UtilsAVX2.hpp:24-74 /
    ProcessNaive.hpp:21-38).  Returns (median, accumulator).

    ``delta = clip(s - m, -1, 1)`` is exactly the reference's
    (+1 if s>m, -1 if s<m, 0 if equal).  After the +delta the accumulator
    is in [-limit-1, limit+1]; the over-limit bump (reference: a clip
    pair) is formulated as two compares + selects — equivalent because acc
    hits ±(limit+1) exactly when the clip pair would bump.
    ``mask`` enables the conditional variant used for IQR quantiles
    (wib/tpg/ProcessAVX2.hpp IQR section; wib2/tpg/ProcessNaive.hpp:94-98);
    masked lanes leave acc unchanged, and the post-reset invariant
    |acc| <= limit means they can never bump, so only delta needs masking.

    ``acc_bias`` runs the update in a translated domain (the accumulator is
    carried as acc+B, reset lands on B): ``frugal_update(m+A, s+A, acc+B,
    L, acc_bias=B) == frugal_update(m, s, acc, L) + (A, B)`` exactly.
    """
    clip = fx.clip if fx is not None else \
        (lambda x, lo, hi: xp.clip(x, lo, hi))
    delta = clip(s - m, -1, 1)
    if mask is not None:
        delta = xp.where(mask, delta, 0)
    acc = acc + delta
    over = acc > limit + acc_bias
    under = acc < -limit + acc_bias
    m = xp.where(over, m + 1, xp.where(under, m - 1, m))
    acc = xp.where(over | under, acc_bias, acc)
    return m, acc


def tpg_tick(st: dict, s_raw, cfg: TPGConfig, xp, fx=None):
    """One time tick of the threshold/RS SWTPG pipeline.

    st: dict with ChanState core fields as (..., C) integer arrays (plus
    ``rs_memory_factor``).  s_raw: (..., C) raw ADC sample.

    Returns (new_st, closed, record) where ``closed`` is the per-channel
    "hit ended this tick" mask (the AVX ``left`` mask,
    ProcessAVX2.hpp:100-102) and ``record`` is a dict of the post-update
    charge/tover/peak_adc/peak_time values to be emitted for closed lanes.
    """
    fx = fx or I32Fx.make(xp)
    one = fx.one
    zero = fx.zero
    out = dict(st)

    # -- pedestal (frugal streaming) ------------------------------------
    ped, acc = frugal_update(st["pedestals"], s_raw, st["accum"],
                             cfg.accumulator_limit, xp, fx=fx)
    out["pedestals"], out["accum"] = ped, acc
    s = s_raw - ped

    # -- filtering stage -------------------------------------------------
    if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD:
        x = s
    elif cfg.algorithm in (Algorithm.ABS_RS, Algorithm.STANDARD_RS):
        if cfg.rs_float:
            # ProcessNaiveRS.hpp:95-103: float R=0.8, scale=2, round()
            v = 0.8 * _astype(st["rs"], "float32")
            if cfg.algorithm == Algorithm.ABS_RS:
                v = v + _astype(xp.abs(s), "float32") / 2.0
            else:
                v = v + _astype(s, "float32")
            # float -> int32 -> the state's dtype (an int16 state wraps)
            rs = _astype(_round_half_away(v, xp), s)
        else:
            # x10 integer fixed point with mulhrs division
            # (ProcessAbsRSAVX2.hpp:137-144 /
            # ProcessStandardRSAVX2.hpp:134-141).  The reference chain is
            # int16 lane ops throughout, so the intermediate wraps are
            # deferred into fx.rs_div10 (mod-2^16 congruence;
            # fixedpoint.rs_div10_unwrapped docs).  Operands are
            # int16-range by construction (state stored wrapped, |s| <=
            # 16383 for 14-bit streams), so the int32 sums cannot overflow.
            if cfg.rs_mf_shift is not None:
                # specialization: mf promised in {0, 1<<shift} -> the
                # vector multiply becomes a masked shift (config.py docs)
                first = xp.where(st["rs_memory_factor"] != 0,
                                 st["rs"] << cfg.rs_mf_shift, zero)
            else:
                first = st["rs"] * st["rs_memory_factor"]
            if cfg.algorithm == Algorithm.ABS_RS:
                second = xp.abs(s) * fx.dtype(cfg.rs_scale_factor_x10)
            else:
                second = s
            rs = fx.rs_div10(first + second)
        # second frugal pedestal, on the RS waveform
        rs_ped, rs_acc = frugal_update(st["pedestals_rs"], rs, st["accum_rs"],
                                       cfg.accumulator_limit, xp, fx=fx)
        out["pedestals_rs"], out["accum_rs"] = rs_ped, rs_acc
        # state stores the post-subtraction RS (ProcessAbsRSAVX2.hpp:159,318)
        if cfg.rs_float:
            # float-mode rs can exceed int16; the sub's wrap is load-bearing
            x = fx.sub16(rs, rs_ped)
        else:
            # fixed point: rs in [-3276, 3276] (mulhrs bound) and the
            # frugal median never steps past the values it tracks, so the
            # int16 wrap of sub_epi16 is unreachable — plain subtract
            x = rs - rs_ped
        out["rs"] = x
    else:
        raise ValueError(f"tpg_tick does not handle {cfg.algorithm}; "
                         "use fir.tpg_tick_fir for the FIR family")

    # -- hit finding ------------------------------------------------------
    is_over = x > cfg.threshold
    if cfg.algorithm in (Algorithm.ABS_RS, Algorithm.STANDARD_RS):
        # st["rs"] IS the previous tick's filtered value (stored
        # post-subtraction), so the reference's prev-over flag
        # (ProcessAVX2.hpp:100-102) is derivable from it.
        closed = (st["rs"] > cfg.threshold) & ~is_over
    else:
        closed = (st["prev_was_over"] != 0) & ~is_over

    # charge accumulates the *pedestal-subtracted ADC* (not the filtered
    # value) in every algorithm of this family; widening accumulate + clamp
    # reproduces the naive "simulated saturated add" (ProcessNaive.hpp:96-99)
    # on top.  The RS family can accumulate NEGATIVE samples while over, so
    # the production AVX adds_epi16 floor at INT16_MIN is reproduced there
    # (PARITY.md "charge saturation"); SimpleThreshold with a positive
    # threshold only ever adds s > threshold > 0, so the floor is skipped.
    need_floor = cfg.algorithm != Algorithm.SIMPLE_THRESHOLD or \
        cfg.threshold < 0
    charge = fx.add_clamp(st["hit_charge"], xp.where(is_over, s, zero),
                          INT16_MAX,
                          floor=-INT16_MAX - 1 if need_floor else None)
    peak_upd = s > st["hit_peak_adc"]
    if cfg.peak_gated:
        peak_upd = peak_upd & is_over
    peak_adc = xp.where(peak_upd, s, st["hit_peak_adc"])
    # peak_time records tover *before* this tick's increment
    # (ProcessAVX2.hpp:134-140, ProcessNaive.hpp:100-105)
    peak_time = xp.where(peak_upd, st["hit_tover"], st["hit_peak_time"])
    tover = fx.add_clamp(st["hit_tover"], xp.where(is_over, one, zero),
                         INT16_MAX)

    record = {"charge": charge, "tover": tover,
              "peak_adc": peak_adc, "peak_time": peak_time}

    # zero the lanes whose hit just closed (ProcessAVX2.hpp:199-204)
    out["hit_charge"] = xp.where(closed, zero, charge)
    out["hit_tover"] = xp.where(closed, zero, tover)
    out["hit_peak_adc"] = xp.where(closed, zero, peak_adc)
    out["hit_peak_time"] = xp.where(closed, zero, peak_time)
    if cfg.algorithm not in (Algorithm.ABS_RS, Algorithm.STANDARD_RS):
        out["prev_was_over"] = xp.where(is_over, one, zero)
    return out, closed, record


def dispatch_tick(st: dict, s_raw, cfg: TPGConfig, xp, fx=None):
    """Algorithm dispatch: threshold/RS families via tpg_tick, FIR family
    via fir.tpg_tick_fir (the reference's function-pointer dispatch,
    WIBEthFrameProcessor.cpp:182-197)."""
    if cfg.algorithm == Algorithm.FIR:
        from .fir import default_taps, tpg_tick_fir
        return tpg_tick_fir(st, s_raw, cfg, xp,
                            cfg.taps or default_taps(cfg), fx=fx)
    return tpg_tick(st, s_raw, cfg, xp, fx=fx)
