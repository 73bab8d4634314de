"""FIR+IQR hit finding in the plain reference, as the deployed AVX2
kernels of upstream fdreadoutlibs compute it (``wib/tpg/ProcessAVX2.hpp``,
``ProcessAVX2FIR.hpp``; the naive ``wib2/tpg/ProcessNaive.hpp:40-160``
states the same steps), per channel and tick:

1. the IQR: the 25th and 75th percentiles are frugal-streaming quantiles,
   the lower one stepped only by a sample below the pedestal as it stood
   before this tick, the upper one only by a sample above it; sigma is
   their difference after the step;
2. the pedestal: a frugal-streaming median of the raw sample (a step of
   one when its accumulator passes +-10, which then restarts at 0);
3. the sample minus the new pedestal, capped at 32767 >> 6 = 511;
4. the filter: the 8 taps of ``firwin_taps`` over the 8 previous capped
   samples, oldest first (this tick's enters the next tick's sum), the sum
   wrapped to int16;
5. the threshold: sigma capped at 32768 / (64 x 5) = 102, times 64, times
   the channel's threshold in sigma, wrapped to int16 (the kernels' int16
   product chain); a tick is over when the filtered value exceeds it;
6. the hit: while over, charge gains the filtered value >> 6 (saturating at
   the int16 limits) and the time over threshold one tick (saturating at
   32767); the first tick not over after one that was closes the hit,
   which is recorded (charge, time over threshold) and cleared.

A channel's state before its first tick: the pedestal its first sample,
the quantiles that sample -20 and +20, all else zero.

Capacity, as the readout deploys it: a channel keeps its first ``k_slots``
closes in each chunk of ``tc`` ticks and counts the rest as dropped; a
plane of a link keeps the first ``max_hits`` hits of a batch in (end tick,
register position) order and counts the rest as dropped.

Departures from upstream, each the readout's own: the hit's peak is not
tracked (the WIB TP takes the midpoint and charge / 20, ``wib_tpsets``);
the K slots a chunk and the batch cap replace upstream's unbounded
per-frame hit lists.
"""

from __future__ import annotations

import math

import torch

# carried per-channel state; ``ring`` (8, C) is the FIR's sample history
STATE_FIELDS = ("pedestal", "accum", "q25", "q75", "accum25", "accum75",
                "prev_over", "charge", "tover")
N_TAPS = 8
STATE_WORDS = len(STATE_FIELDS) + N_TAPS
HIT_FIELDS = ("channel", "end_tick", "charge", "tover")
TAP_EXPONENT = 6
MULTIPLIER = 1 << TAP_EXPONENT
SAMPLE_CAP = 32767 // MULTIPLIER
ACCUMULATOR_LIMIT = 10
SIGMA_CAP = (1 << 15) // (MULTIPLIER * 5)
SEED_SPREAD = 20
INT16_MIN, INT16_MAX = -32768, 32767


def firwin_taps(n: int = 7, cutoff: float = 0.1,
                multiplier: int = MULTIPLIER) -> list[int]:
    """The integer low-pass of upstream ``DesignFIR.cpp``: a Hamming
    window times sinc(cutoff (m - n // 2)), normalised to a unit sum, times
    the multiplier and rounded, then one zero tap."""
    half = n // 2
    h = [(0.54 - 0.46 * math.cos(2 * math.pi * m / (n - 1)))
         * (1.0 if m == half else
            math.sin(math.pi * cutoff * (m - half))
            / (math.pi * cutoff * (m - half)))
         for m in range(n)]
    total = sum(h)
    return [int(round(multiplier * v / total)) for v in h] + [0]


def seed_state(first: torch.Tensor) -> dict:
    """The state before a channel's first tick, from that tick's samples."""
    first = first.to(torch.int32)
    st = {f: torch.zeros_like(first) for f in STATE_FIELDS}
    st["pedestal"] = first.clone()
    st["q25"] = first - SEED_SPREAD
    st["q75"] = first + SEED_SPREAD
    st["ring"] = torch.zeros((N_TAPS, first.shape[0]), dtype=torch.int32)
    return st


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 32768) & 0xFFFF) - 32768


def _frugal(q: torch.Tensor, acc: torch.Tensor, x: torch.Tensor,
            gate: torch.Tensor | None = None) -> None:
    """One frugal-streaming step of ``q`` toward ``x``, in place; lanes
    where ``gate`` is false do not move."""
    step = torch.sign(x - q)
    if gate is not None:
        step *= gate
    acc += step
    up = acc > ACCUMULATOR_LIMIT
    down = acc < -ACCUMULATOR_LIMIT
    q += up
    q -= down.to(torch.int32)
    acc *= ~(up | down)


def run(adcs: torch.Tensor, state: dict, thresholds: torch.Tensor, *,
        tc: int, k_slots: int, taps: list[int] | None = None):
    """(T, C) int32 samples from ``state``, with (C,) thresholds in sigma.

    Returns (closes, nclose, new_state): ``closes`` the kept hits' fields
    as int64 tensors (``end_tick`` run-local, ``channel`` the index on the
    channel axis), in (end tick, channel) order; ``nclose`` (T / tc, C)
    every close counted a chunk; ``new_state`` the state after tick T-1.
    ``tc`` must divide T."""
    T, C = adcs.shape
    if T % tc:
        raise ValueError(f"chunk {tc} does not divide {T} ticks")
    taps = firwin_taps() if taps is None else list(taps)
    st = {f: state[f].to(torch.int32).clone() for f in STATE_FIELDS}
    ped, acc, q25, q75, a25, a75 = (st[f] for f in STATE_FIELDS[:6])
    charge, tover = st["charge"], st["tover"]
    prev = st["prev_over"] != 0
    ring = state["ring"].to(torch.int32).clone()
    # rotated taps: with the oldest sample in ring row p, tap j meets row
    # (p + j) % 8
    rot = torch.zeros((N_TAPS, N_TAPS, 1), dtype=torch.int32)
    for p in range(N_TAPS):
        for j, t in enumerate(taps):
            rot[p, (p + j) % N_TAPS, 0] = t
    scale = thresholds.to(torch.int32) * MULTIPLIER
    adcs = adcs.to(torch.int32)
    nclose = torch.zeros((T // tc, C), dtype=torch.int32)
    kept = []
    closed_buf = torch.zeros((tc, C), dtype=torch.bool)
    charge_buf = torch.zeros((tc, C), dtype=torch.int32)
    tover_buf = torch.zeros((tc, C), dtype=torch.int32)
    p = 0
    for t in range(T):
        x = adcs[t]
        below, above = x < ped, x > ped
        _frugal(q25, a25, x, below)
        _frugal(q75, a75, x, above)
        sigma = q75 - q25
        _frugal(ped, acc, x)
        s = torch.clamp_max(x - ped, SAMPLE_CAP)
        filt = _wrap16((rot[p] * ring).sum(0, dtype=torch.int32))
        ring[p] = s
        p = (p + 1) % N_TAPS
        over = filt > _wrap16(torch.clamp_max(sigma, SIGMA_CAP) * scale)
        closed = prev & ~over
        charge += (filt >> TAP_EXPONENT) * over
        charge.clamp_(INT16_MIN, INT16_MAX)
        tover += over
        tover.clamp_max_(INT16_MAX)
        i = t % tc
        closed_buf[i] = closed
        charge_buf[i] = charge
        tover_buf[i] = tover
        still = ~closed
        charge *= still
        tover *= still
        prev = over
        if i == tc - 1:
            kept.append(_chunk_closes(closed_buf, charge_buf, tover_buf,
                                      t + 1 - tc, k_slots))
            nclose[t // tc] = closed_buf.sum(0, dtype=torch.int32)
    closes = {f: torch.cat([k[f] for k in kept]) for f in HIT_FIELDS}
    order = torch.argsort(closes["end_tick"] * C + closes["channel"])
    closes = {f: v[order] for f, v in closes.items()}
    new_state = {f: st[f] for f in STATE_FIELDS}
    new_state["prev_over"] = prev.to(torch.int32)
    new_state["ring"] = torch.roll(ring, -p, 0)
    return closes, nclose, new_state


def _chunk_closes(closed, charge, tover, t0: int, k_slots: int) -> dict:
    """The closes one chunk keeps: a channel's first ``k_slots``."""
    rank = torch.cumsum(closed.to(torch.int32), 0)
    tick, chan = torch.nonzero(closed & (rank <= k_slots), as_tuple=True)
    return {"channel": chan, "end_tick": tick + t0,
            "charge": charge[tick, chan].to(torch.int64),
            "tover": tover[tick, chan].to(torch.int64)}


def batch_hits(closes: dict, nclose: torch.Tensor, *, ticks: slice,
               channels: slice, tc: int, k_slots: int, max_hits: int):
    """The hits of one plane of one link in one batch, as the readout
    delivers them: ``channels`` a span of the channel axis (its register
    positions), ``ticks`` the batch's run-local ticks; sorted by (end tick,
    register position), at most ``max_hits``, with the dropped count.  End
    ticks are batch-local, channels register positions."""
    tk, ch = closes["end_tick"], closes["channel"]
    sel = ((tk >= ticks.start) & (tk < ticks.stop)
           & (ch >= channels.start) & (ch < channels.stop))
    hits = {"channel": ch[sel] - channels.start,
            "end_tick": tk[sel] - ticks.start,
            "charge": closes["charge"][sel], "tover": closes["tover"][sel]}
    valid = len(hits["channel"])
    hits = {f: v[:max_hits] for f, v in hits.items()}
    chunks = nclose[ticks.start // tc:ticks.stop // tc,
                    channels.start:channels.stop]
    dropped = int(torch.clamp_min(chunks - k_slots, 0).sum()) \
        + max(valid - max_hits, 0)
    return hits, dropped
