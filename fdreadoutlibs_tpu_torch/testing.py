"""Seeded inputs shared by the port's tests and ``chip_smoke.py``.

Everything is made with numpy from a seed, so the JAX package, the plain
version and the CUDA kernel all see the same samples.
"""

from __future__ import annotations

import numpy as np


def tpg_stream(T: int, C: int, tc: int, k_slots: int, seed: int):
    """A (T, C) int32 ADC window that exercises the TPG's edge cases, and
    per-channel RS memory factors in threshold-on-collection style
    ({0, 8}: even channels memoryless).

    Besides noise around 900 ADC and random pulses it holds a pulse
    straddling every tc-chunk boundary and one channel that closes
    ``k_slots + 2`` hits inside its first chunk (so that chunk drops
    two).  Returns (adcs, rs_memory_factor)."""
    rng = np.random.default_rng(seed)
    adcs = (900 + rng.normal(0, 20, size=(T, C))).astype(np.int32)
    for _ in range(max(8, C // 4)):
        c, t = rng.integers(0, C), rng.integers(1, T - 12)
        adcs[t:t + rng.integers(2, 10), c] += rng.integers(300, 3000)
    for b in range(1, T // tc):             # pulses over chunk boundaries
        adcs[b * tc - 3:b * tc + 3, (37 * b) % C] += 2000
    burst = (7 * seed + 3) % C              # > k_slots closes in one chunk
    n_burst = k_slots + 2
    step = tc // n_burst
    if step < 12:
        raise ValueError(f"tc={tc} too short for {n_burst} separate hits")
    for j in range(n_burst):
        adcs[j * step + 2:j * step + 4, burst] += 3000
    rmf = np.where(np.arange(C) % 2 == 0, 0, 8).astype(np.int32)
    return np.clip(adcs, 0, (1 << 14) - 1), rmf


def time2_words(adcs: np.ndarray) -> np.ndarray:
    """(T, C) samples -> (T/2, C) int32 time-paired words, tick 2j in the
    low and 2j+1 in the high 16 bits (the layout of
    ``native.relayout_time2`` without its lane padding)."""
    a = np.asarray(adcs, dtype=np.int32)
    return np.ascontiguousarray(a[0::2] | (a[1::2] << 16))


def frame_words(adcs: np.ndarray) -> np.ndarray:
    """(T, C) ADCs, C = 64 L -> (L, T, 28) uint32 packed WIBEth frame
    words (channel = link*64 + c), packed as ``wibeth.set_adcs`` packs a
    frame's rows."""
    from .formats.bitpack import pack_14bit
    T, C = np.shape(adcs)
    w = pack_14bit(np.asarray(adcs).reshape(T, C // 64, 64), n_words=28)
    return np.ascontiguousarray(w.transpose(1, 0, 2))


def fir_stream(T: int, C: int, tc: int, k_slots: int, seed: int):
    """:func:`tpg_stream`'s window with the FIR family's edge cases added:
    wide-noise channels (an IQR above the AVX sigma clamp), a long pulse
    that saturates the charge at 32767, a deep undershoot (negative filter
    values) and samples at the 14-bit ceiling (the adc_max clamp).  The
    burst channel still closes ``k_slots + 2`` hits in its first chunk.
    Returns (T, C) int32 ADCs."""
    adcs, _ = tpg_stream(T, C, tc, k_slots, seed)
    rng = np.random.default_rng(seed + 1)
    burst = (7 * seed + 3) % C
    others = np.setdiff1d(np.arange(C), [burst])
    picks = rng.choice(others, size=max(4, C // 16) + 3, replace=False)
    wide, (long_c, under_c, ceil_c) = picks[:-3], picks[-3:]
    adcs[:, wide] += rng.normal(0, 150, size=(T, len(wide))).astype(np.int32)
    t = T // 4
    adcs[t:t + min(120, T // 4), long_c] += 4000
    adcs[T // 2:T // 2 + 20, under_c] -= 800
    adcs[T // 3:T // 3 + 5, ceil_c] = (1 << 14) - 1
    return np.clip(adcs, 0, (1 << 14) - 1)


def wib2_superchunks(n_links: int, n_superchunks: int, seed: int,
                     ts0: int = 0x1000000, crate: int = 1, slot: int = 0,
                     n_pulses: int | None = None):
    """Seeded WIB2 data for ``n_links`` links: noise around 900 ADC
    (sigma 30) and 8-tick pulses of 300-3000 ADC, as
    ``scripts/bench_frontends.py::_noise_pulses`` makes them (default
    max(20, C/16) pulses); frame timestamps advance 32 ticks per frame from
    ``ts0``; link l carries geo-id (crate, slot, l).

    Returns ((L, N, 5664) uint8 superchunks, (L, 12 N, 256) int32 ADCs)."""
    from .formats import wib2
    L, T = n_links, n_superchunks * wib2.FRAMES_PER_SUPERCHUNK
    C = wib2.N_CHANNELS
    rng = np.random.default_rng(seed)
    adcs = (900 + rng.normal(0, 30, size=(L, T, C))).astype(np.int32)
    for _ in range(n_pulses if n_pulses is not None
                   else max(20, L * C // 16)):
        l, c, t = rng.integers(0, L), rng.integers(0, C), \
            rng.integers(0, T - 8)
        adcs[l, t:t + 8, c] += rng.integers(300, 3000)
    adcs = np.clip(adcs, 0, (1 << 14) - 1)
    sc = np.zeros((L, n_superchunks, wib2.SUPERCHUNK_SIZE), dtype=np.uint8)
    for l in range(L):
        wib2.set_adcs(wib2.superchunk_frames(sc[l]),
                      adcs[l].reshape(n_superchunks,
                                      wib2.FRAMES_PER_SUPERCHUNK, C))
        wib2.fake_timestamps(sc[l], ts0)
        wib2.fake_geoid(sc[l], crate, slot, l)
    return sc, adcs
