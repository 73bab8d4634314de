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
