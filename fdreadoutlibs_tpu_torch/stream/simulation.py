"""Physics-like signal simulation for validation and benchmarking.

Port copy of ``fdreadoutlibs_tpu/stream/simulation.py:1-79``
(numpy); the code is unchanged.

The reference's validation inputs are single-channel geometric patterns
(docs/README.md).  This module generates DUNE-like conditions so algorithm
behavior (e.g. why the running-sum family exists) can be exercised:

* straight ionization tracks crossing channels over time;
* unipolar (collection-plane) or bipolar (induction-plane) pulse shapes —
  induction wires see the drifting charge approach then recede, so the
  signal integrates to ~zero and defeats a plain threshold;
* common-mode (coherent) low-frequency noise per link plus white noise —
  what the frugal-streaming pedestal is designed to track.
"""

from __future__ import annotations

import numpy as np


def unipolar_pulse(length: int = 12, amplitude: float = 1.0) -> np.ndarray:
    """Collection-plane shape: fast rise, slower fall."""
    t = np.arange(length)
    shape = t * np.exp(1 - t / 3.0)
    return amplitude * shape / shape.max()


def bipolar_pulse(length: int = 16, amplitude: float = 1.0) -> np.ndarray:
    """Induction-plane shape: positive then negative lobe, ~zero integral."""
    t = np.arange(length) - length / 2
    shape = -t * np.exp(-(t / (length / 5.0)) ** 2)
    return amplitude * shape / np.abs(shape).max()


def simulate_stream(T: int, C: int, seed: int = 0, *, pedestal: int = 900,
                    white_noise: float = 3.0, coherent_noise: float = 4.0,
                    coherent_period: int = 200, n_tracks: int = 4,
                    track_charge: float = 600.0, induction_planes=None):
    """Generate a (T, C) int32 ADC stream plus ground truth.

    induction_planes: bool array (C,) — channels that see bipolar pulses
    (default: the upper half of the channel range).

    Returns (adcs, truth) where truth is a list of
    (channel, t_start, amplitude) for every deposited pulse.
    """
    rng = np.random.default_rng(seed)
    if induction_planes is None:
        induction_planes = np.arange(C) >= C // 2
    adcs = pedestal + rng.normal(0, white_noise, size=(T, C))
    # coherent noise: slow sinusoid + random walk, common to all channels
    phase = rng.uniform(0, 2 * np.pi)
    common = coherent_noise * np.sin(
        2 * np.pi * np.arange(T) / coherent_period + phase)
    common += np.cumsum(rng.normal(0, coherent_noise / 50, size=T))
    adcs += common[:, None]

    truth = []
    uni = unipolar_pulse()
    bi = bipolar_pulse()
    for _ in range(n_tracks):
        # a track crosses a span of channels with linear time progression
        c0 = int(rng.integers(0, C))
        span = int(rng.integers(3, max(4, C // 2)))
        direction = 1 if rng.random() < 0.5 else -1
        t0 = int(rng.integers(1, max(2, T - 200)))
        dt_per_ch = rng.uniform(0.5, 4.0)
        for i in range(span):
            c = c0 + direction * i
            if not 0 <= c < C:
                break
            t = int(t0 + i * dt_per_ch)
            amp = track_charge * rng.uniform(0.6, 1.4)
            shape = bi if induction_planes[c] else uni
            seg = shape * amp
            end = min(T, t + len(seg))
            if t < T:
                adcs[t:end, c] += seg[: end - t]
                truth.append((c, t, amp))
    return np.clip(adcs, 0, (1 << 14) - 1).astype(np.int32), truth
