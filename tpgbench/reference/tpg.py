"""AbsRS trigger-primitive generation in the plain reference.

The per-channel, per-tick arithmetic of the deployed AVX2 kernels
(``ProcessAbsRSAVX2.hpp``, with the naive oracles' record fields): a
frugal-streaming pedestal, the x10 fixed-point running sum of the
pedestal-subtracted sample's magnitude with an int16 wrap and the
``mulhrs`` division by 10, a second frugal pedestal on the running sum,
a threshold on the result, and hits that integrate the
pedestal-subtracted sample (saturating at the int16 limits) while over.

Capacity, as the readout deploys it: a channel stores its first K closes
in each chunk of ``tc`` ticks and counts the rest as dropped; a batch
delivers its first ``max_hits`` hits in (end tick, channel) order and
counts the rest as dropped.
"""

from __future__ import annotations

import numpy as np

# carried per-channel state, in the order the readout's state rows keep it
STATE_FIELDS = ("pedestals", "accum", "rs", "pedestals_rs", "accum_rs",
                "hit_charge", "hit_tover", "hit_peak_adc", "hit_peak_time")
HIT_FIELDS = ("channel", "end_tick", "charge", "tover", "peak_adc",
              "peak_time")
INT16_MIN, INT16_MAX = -32768, 32767


def seed_state(first: np.ndarray, memory_factor: np.ndarray) -> dict:
    """A channel's state before its first tick: the pedestal is its first
    sample, everything else zero; the RS memory factor (x10) per channel."""
    st = {f: np.zeros(first.shape, dtype=np.int32) for f in STATE_FIELDS}
    st["pedestals"] = np.asarray(first, dtype=np.int32).copy()
    st["memory_factor"] = np.asarray(memory_factor, dtype=np.int32).copy()
    return st


def chunk_ticks(T: int, tc: int) -> int:
    """The chunk the readout uses for a batch of T ticks: the largest
    divisor of T not above the configured chunk."""
    for c in range(min(T, tc), 0, -1):
        if T % c == 0:
            return c
    return T


def _frugal(m, acc, s, limit):
    acc += np.sign(s - m).astype(np.int32)
    over, under = acc > limit, acc < -limit
    m += over
    m -= under
    acc[over | under] = 0


def run(adcs: np.ndarray, state: dict, *, threshold: int,
        accumulator_limit: int, scale_x10: int, tc: int, k_slots: int):
    """Process (T, C) int32 samples from ``state``.

    Returns (closes, nclose, new_state): ``closes`` a dict of the kept
    hits' fields (``tick`` is the run-local tick at which the hit closed,
    ``channel`` its index on the channel axis), ``nclose`` (T / tc, C)
    every close counted per chunk, ``new_state`` the state after tick T-1.
    ``tc`` must divide T."""
    T, C = adcs.shape
    if T % tc:
        raise ValueError(f"chunk {tc} does not divide {T} ticks")
    ped, acc, rs, rped, racc, chg, tov, pk, pt = (
        state[f].astype(np.int32).copy() for f in STATE_FIELDS)
    mf = state["memory_factor"].astype(np.int32)
    thr = np.int32(threshold)
    ncl = np.zeros(C, dtype=np.int32)
    nclose = np.zeros((T // tc, C), dtype=np.int32)
    out_t, out_c, out_f = [], [], []
    for t in range(T):
        if t % tc == 0 and t:
            nclose[t // tc - 1] = ncl
            ncl[:] = 0
        x = adcs[t]
        _frugal(ped, acc, x, accumulator_limit)
        s = x - ped
        a = rs * mf + np.abs(s) * np.int32(scale_x10)
        a = ((a + 32768) & 0xFFFF) - 32768
        rsn = (a * 3276 + 16384) >> 15
        _frugal(rped, racc, rsn, accumulator_limit)
        xf = rsn - rped
        over = xf > thr
        closed = (rs > thr) & ~over
        chg = np.clip(chg + np.where(over, s, 0), INT16_MIN, INT16_MAX)
        peak = s > pk
        pk = np.where(peak, s, pk)
        pt = np.where(peak, tov, pt)
        tov = np.minimum(tov + over, INT16_MAX).astype(np.int32)
        idx = np.flatnonzero(closed)
        if idx.size:
            keep = idx[ncl[idx] < k_slots]
            ncl[idx] += 1
            if keep.size:
                out_t.append(np.full(keep.size, t, dtype=np.int64))
                out_c.append(keep)
                out_f.append(np.stack([chg[keep], tov[keep], pk[keep],
                                       pt[keep]], axis=1))
            chg[idx] = 0
            tov[idx] = 0
            pk[idx] = 0
            pt[idx] = 0
        rs = xf
    nclose[-1] = ncl
    f = np.concatenate(out_f) if out_f else np.zeros((0, 4), np.int32)
    closes = {"tick": np.concatenate(out_t) if out_t else
              np.zeros(0, np.int64),
              "channel": np.concatenate(out_c) if out_c else
              np.zeros(0, np.int64),
              "charge": f[:, 0], "tover": f[:, 1], "peak_adc": f[:, 2],
              "peak_time": f[:, 3]}
    new_state = dict(zip(STATE_FIELDS, (ped, acc, rs, rped, racc, chg, tov,
                                        pk, pt)))
    new_state["memory_factor"] = mf.copy()
    return closes, nclose, new_state


def batch_hits(closes: dict, nclose: np.ndarray, *, ticks: slice, tc: int,
               k_slots: int, max_hits: int, tick_offset: int = 0):
    """One run's hits of one batch, as the readout delivers them: sorted
    by (end tick, channel), at most ``max_hits``, with the dropped count.
    ``ticks`` are the batch's run-local ticks; end ticks are batch-local
    plus ``tick_offset``."""
    tk = closes["tick"]
    sel = (tk >= ticks.start) & (tk < ticks.stop)
    hits = {"channel": closes["channel"][sel].astype(np.int64),
            "end_tick": (tk[sel] - ticks.start + tick_offset)
            .astype(np.int64)}
    for f in ("charge", "tover", "peak_adc", "peak_time"):
        hits[f] = closes[f][sel].astype(np.int64)
    order = np.lexsort((hits["channel"], hits["end_tick"]))
    hits = {k: v[order][:max_hits] for k, v in hits.items()}
    chunks = nclose[ticks.start // tc:ticks.stop // tc]
    valid = int(sel.sum())
    dropped = int(np.maximum(chunks - k_slots, 0).sum()) \
        + max(valid - max_hits, 0)
    return hits, dropped

