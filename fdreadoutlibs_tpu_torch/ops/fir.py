"""FIR+IQR SWTPG family (the WIB/WIB2 legacy kernels).

Copied from ``fdreadoutlibs_tpu/ops/fir.py:1-338``, unchanged in its
arithmetic, with the packed SWAR state layout of ``tpg_tick_fir``
(:264-332, the ``fir_packed`` carry: the plain version of K3b).

Covers DesignFIR.{hpp,cpp} (scipy firwin ported to integer taps) and the
FIR pipeline of wib2/tpg/ProcessNaive.hpp:40-160 / ProcessAVX2FIR.hpp and
wib/tpg/ProcessAVX2.hpp:79-376:

* IQR noise estimate: frugal-streaming 25th/75th quantiles updated only
  when the sample is below/above the median (ProcessNaive.hpp:94-98);
  sigma = q75 - q25;
* 8-tap integer FIR over the pedestal-subtracted, adcMax-clamped samples,
  kept oldest-first (filt_t = sum_j taps[j] * s_{t-8+j}, taps[7] = 0);
* dynamic threshold in sigma units: naive compares
  filt > threshold * sigma * multiplier in full precision
  (ProcessNaive.hpp:123 with threshold=5); the AVX2 kernel clamps sigma to
  32768/(multiplier*5) and wraps the int16 product chain
  (ProcessAVX2FIR.hpp:36,133,208) — both behaviors are selectable via
  ``fir_avx_semantics`` (default True = deployed behavior);
* charge accumulates filt >> tap_exponent (ProcessNaive.hpp:127).
"""

from __future__ import annotations

import math

from .config import TPGConfig
from .fixedpoint import I32Fx
from .step import frugal_update

INT16_MAX = 32767
NTAPS = 8


# ---- filter design (DesignFIR.cpp ported) --------------------------------------

def hamming(M: int) -> list[float]:
    """DesignFIR.cpp:20-28."""
    return [0.54 - 0.46 * math.cos(2.0 * math.pi * n / (M - 1))
            for n in range(M)]


def sinc(x: float) -> float:
    if x == 0:
        return 1.0
    return math.sin(math.pi * x) / (math.pi * x)


def firwin(N: int, cutoff: float) -> list[float]:
    """Normalized lowpass (DesignFIR.cpp:38-53); cutoff in Nyquist units."""
    alpha = N // 2
    window = hamming(N)
    ret = [window[m] * sinc(cutoff * (m - alpha)) for m in range(N)]
    s = sum(ret)
    return [v / s for v in ret]


def firwin_int(N: int, cutoff: float, multiplier: int) -> list[int]:
    """Integer taps: round(multiplier * firwin) (DesignFIR.cpp:56-66)."""
    return [int(round(multiplier * v)) for v in firwin(N, cutoff)]


def default_taps(cfg: TPGConfig) -> tuple:
    """The reference's production taps: firwin_int(7, 0.1, multiplier) with a
    trailing 0 (WIB2FrameProcessor.cpp:93-94)."""
    return tuple(firwin_int(7, 0.1, cfg.multiplier)) + (0,)


# ---- composable tick pieces -----------------------------------------------------
#
# :func:`tpg_tick_fir` composes these pieces in per-tick order; the two-pass
# schedule (``ops/tpg.process_window_twopass_plain``, K5) calls the SAME
# pieces in a split order — the recurrent state pass per tick, then
# filter+threshold on whole (tc, C) time slabs, then the recurrent hit pass
# per tick.  Every piece is elementwise over its array arguments and
# therefore shape-polymorphic between per-tick rows and time slabs.

def fir_iqr_update(st: dict, s_raw, cfg: TPGConfig, xp, fx):
    """Merged active-quantile IQR chain (unpacked state layout).

    IQR quantiles are gated on the *pre-update* median
    (ProcessNaive.hpp:94-98).  The two gates s<med0 / s>med0 are mutually
    exclusive, so at most ONE of the q25/q75 chains moves per tick — one
    shared delta/bump datapath with select-in / select-out.  Bit-exact vs
    the two-chain form: gated lanes see exactly their own (q, acc) and the
    un-gated chain can never bump because the stored accumulator obeys
    |acc| <= limit post-reset.

    Returns ``(updates, sigma)`` where updates covers the four quantile
    rows and ``sigma = q75 - q25``.
    """
    med0 = st["pedestals"]
    lt = s_raw < med0
    gt = s_raw > med0
    q25, q75 = st["quantile25"], st["quantile75"]
    a25, a75 = st["accum25"], st["accum75"]
    qa = xp.where(lt, q25, q75)
    aa = xp.where(lt, a25, a75)
    qa, aa = frugal_update(qa, s_raw, aa, cfg.accumulator_limit, xp,
                           mask=lt | gt, fx=fx)
    q25n = xp.where(lt, qa, q25)
    q75n = xp.where(gt, qa, q75)
    upd = {"quantile25": q25n, "accum25": xp.where(lt, aa, a25),
           "quantile75": q75n, "accum75": xp.where(gt, aa, a75)}
    return upd, q75n - q25n


def fir_pedestal_sub(st: dict, s_raw, cfg: TPGConfig, xp, fx):
    """Pedestal frugal update + pre-filter clamp (ProcessNaive.hpp:88-91,
    120).  Reads the pre-update ``st["pedestals"]``; returns
    ``(updates, s)`` with s = min(s_raw - med_new, adc_max)."""
    med, acc = frugal_update(st["pedestals"], s_raw, st["accum"],
                             cfg.accumulator_limit, xp, fx=fx)
    s = s_raw - med
    s = fx.minimum(s, fx.dtype(cfg.adc_max))
    return {"pedestals": med, "accum": acc}, s


def fir_filter(buf, taps: tuple, fx):
    """8-tap integer FIR over the NTAPS previous samples, oldest-first.

    Per-op int16 wraps and a single wrap-at-end are congruent mod 2^16.
    Equal coefficients share one multiply and power-of-two coefficients
    become shifts — exact integer arithmetic, same wrapped result.

    ``buf`` is any sequence of NTAPS arrays: per-tick (..., C) rows in the
    fused tick, or (tc, C) shifted slab views of one contiguous sample
    buffer in the two-pass schedule.
    """
    groups: dict[int, list] = {}
    for j, t in enumerate(taps):
        if t:
            groups.setdefault(int(t), []).append(j)
    filt_acc = fx.zero
    for t, js in groups.items():
        g = buf[js[0]]
        for j in js[1:]:
            g = g + buf[j]
        if t == 1:
            term = g
        elif t > 0 and t & (t - 1) == 0:
            term = g << (t.bit_length() - 1)
        else:
            term = g * fx.dtype(t)
        filt_acc = filt_acc + term
    return fx.wrap(filt_acc)


def fir_threshold(filt, sigma, cfg: TPGConfig, fx):
    """Dynamic threshold in sigma units; returns the is_over mask.

    AVX semantics (default deployed behavior): clamp sigma to
    32768/(multiplier*5) and wrap the int16 product chain
    (ProcessAVX2FIR.hpp:36,133,208), with the first multiply a shift and
    the intermediate wrap deferred through the second product
    (wrap(wrap(a)*T) == wrap(a*T) by mod-2^16 congruence) PROVIDED a*T
    fits int32 — the wrap is kept when it may not.

    Naive semantics: full-precision product (ProcessNaive.hpp:123-124).
    """
    if cfg.fir_avx_semantics:
        sigma_c = fx.minimum(sigma,
                             fx.dtype((1 << 15) // (cfg.multiplier * 5)))
        a_max = (1 << 16) << cfg.tap_exponent
        prod = sigma_c << cfg.tap_exponent
        if a_max * max(abs(cfg.threshold), 1) >= 2 ** 31:
            prod = fx.wrap(prod)       # pathological threshold: keep wrap
        thr = fx.wrap(prod * fx.dtype(cfg.threshold))
        return filt > thr
    return fx.widen(filt) > (cfg.threshold * cfg.multiplier) * \
        fx.widen(sigma)


def fir_to_add(filt, is_over, cfg: TPGConfig, xp, fx):
    """Per-tick charge contribution: filt >> tap_exponent while over
    (ProcessNaive.hpp:127)."""
    return xp.where(is_over, filt >> cfg.tap_exponent, fx.zero)


def fir_hit_update(st: dict, is_over, to_add, filt, cfg: TPGConfig, xp, fx,
                   closed=None):
    """Recurrent hit-state chain (unpacked layout): close detection,
    saturating charge/tover accumulation, optional peak tracking.

    ``filt`` is read only when ``cfg.track_peaks``; pass None otherwise.
    Returns ``(updates, closed, record)``.

    ``closed`` (schedule plumbing, not physics): the lifted-emission
    two-pass schedule precomputes closed = prev_over & ~is_over as a whole
    time slab and then neither reads nor carries ``prev_was_over`` here —
    when given, the updates omit that row.
    """
    one, zero = fx.one, fx.zero
    charge0 = st["hit_charge"]
    tover0 = st["hit_tover"]
    precomputed_closed = closed is not None
    if not precomputed_closed:
        prev_over = st["prev_was_over"] != 0
        closed = prev_over & ~is_over
    # filt can be negative while over (wrapped threshold product), so the
    # AVX adds_epi16 floor applies (PARITY.md "charge saturation")
    charge = fx.add_clamp(charge0, to_add, INT16_MAX,
                          floor=-INT16_MAX - 1)
    out = {}
    if cfg.track_peaks:
        peak_upd = filt > st["hit_peak_adc"]
        if cfg.peak_gated:
            peak_upd = peak_upd & is_over
        peak_adc = xp.where(peak_upd, filt, st["hit_peak_adc"])
        peak_time = xp.where(peak_upd, tover0, st["hit_peak_time"])
        out["hit_peak_adc"] = xp.where(closed, zero, peak_adc)
        out["hit_peak_time"] = xp.where(closed, zero, peak_time)
    else:
        peak_adc = peak_time = xp.zeros_like(charge)
    tover = fx.add_clamp(tover0, xp.where(is_over, one, zero), INT16_MAX)
    record = {"charge": charge, "tover": tover,
              "peak_adc": peak_adc, "peak_time": peak_time}
    out["hit_charge"] = xp.where(closed, zero, charge)
    out["hit_tover"] = xp.where(closed, zero, tover)
    if not precomputed_closed:
        out["prev_was_over"] = xp.where(is_over, one, zero)
    return out, closed, record


# ---- the FIR tick ---------------------------------------------------------------

def tpg_tick_fir(st: dict, s_raw, cfg: TPGConfig, xp, taps: tuple, fx=None):
    """One tick of the FIR+IQR pipeline over (..., C) arrays.

    ``st`` additionally carries ``fir_prev``: the previous NTAPS samples,
    oldest-first — either a (NTAPS, ..., C) array or a tuple of NTAPS
    (..., C) arrays (the plain version's carry: the per-tick ring shift is
    a tuple rotation).  Returns (new_st, closed, record) like tpg_tick.
    """
    fx = fx or I32Fx.make(xp)
    out = dict(st)
    limit = cfg.accumulator_limit

    # Packed SWAR state layout (the fir_packed kernel carry): the four IQR
    # arrays ride as two int32 words with biased-unsigned 16-bit halves
    # (q25+2^15 | (q75+2^15)<<16; same for the accumulators), and hit
    # charge/tover/prev_was_over ride as one word (charge<<16 | tover,
    # prev_was_over in bit 15 — tover <= 32767 by the add_clamp, so the
    # bit is free), cutting the loop-carried arrays 17 -> 13.  The frugal
    # updates run in the biased domain via frugal_update's translation
    # equivariance (acc_bias docs).  In-range contract (14-bit streams):
    # quantiles in [0, ~16400] so the biased halves fit 16 bits.
    packed_iqr = "iqr_qpair" in st
    _B = 1 << 15

    if packed_iqr:
        # IQR gated on the *pre-update* median (ProcessNaive.hpp:94-98)
        med0 = st["pedestals"]
        qp, ap = st["iqr_qpair"], st["iqr_apair"]
        sb = s_raw + _B
        q25b, a25b = frugal_update(qp & 0xFFFF, sb, ap & 0xFFFF, limit,
                                   xp, mask=s_raw < med0, fx=fx, acc_bias=_B)
        q75b, a75b = frugal_update((qp >> 16) & 0xFFFF, sb,
                                   (ap >> 16) & 0xFFFF, limit,
                                   xp, mask=s_raw > med0, fx=fx, acc_bias=_B)
        out["iqr_qpair"] = q25b | (q75b << 16)
        out["iqr_apair"] = a25b | (a75b << 16)
        sigma = q75b - q25b
    else:
        upd, sigma = fir_iqr_update(st, s_raw, cfg, xp, fx)
        out.update(upd)
    updp, s = fir_pedestal_sub(st, s_raw, cfg, xp, fx)
    out.update(updp)

    # 8-tap FIR over the previous 8 samples (current sample enters next
    # tick): buf holds s_{t-8}..s_{t-1} oldest-first (fir_filter docs)
    buf = st["fir_prev"]
    filt = fir_filter(buf, taps, fx)
    if isinstance(buf, tuple):
        out["fir_prev"] = buf[1:] + (s,)
    else:
        out["fir_prev"] = xp.concatenate([buf[1:], s[None]], axis=0)

    is_over = fir_threshold(filt, sigma, cfg, fx)
    to_add = fir_to_add(filt, is_over, cfg, xp, fx)

    if packed_iqr:
        # unpack the hit word into the canonical rows, run the shared hit
        # chain, re-pack; hit_charge/tover/prev updates are discarded
        # (only hit_ct is carried) but the peak rows pass through
        ct = st["hit_ct"]
        st_h = dict(st)
        st_h["hit_charge"] = ct >> 16          # sign-extending
        st_h["hit_tover"] = ct & 0x7FFF
        st_h["prev_was_over"] = (ct >> 15) & 1
        updh, closed, record = fir_hit_update(
            st_h, is_over, to_add, filt if cfg.track_peaks else None,
            cfg, xp, fx)
        for k in ("hit_peak_adc", "hit_peak_time"):
            if k in updh:
                out[k] = updh[k]
        # w0 is exactly the kernel's packed record word — the emission
        # reuses it instead of re-packing
        w0 = (record["charge"] << 16) | record["tover"]
        record["w0"] = w0
        out["hit_ct"] = xp.where(closed, 0, w0) | \
            xp.where(is_over, 0x8000, 0)
    else:
        updh, closed, record = fir_hit_update(
            st, is_over, to_add, filt if cfg.track_peaks else None, cfg,
            xp, fx)
        out.update(updh)
    return out, closed, record
