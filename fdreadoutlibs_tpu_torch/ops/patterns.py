"""Validation pattern generators (docs/README.md:67-146 of the reference).

Port copy of ``fdreadoutlibs_tpu/ops/patterns.py:1-110``
(numpy); the code is unchanged.

Patterns are defined over an all-zero (or constant-pedestal) background:

* ``golden``      — the 9-sample hill [500,502,504,505,506,505,504,502,500]
                    placed at a tick offset in every 64-tick frame;
* ``pulse``       — a single-sample spike on one channel/tick;
* ``edge_square`` — a square pulse straddling a frame boundary;
* ``edge_left``   — triangular pulse peaking in the earlier frame;
* ``edge_right``  — triangular pulse peaking in the later frame.

Generators return (T, C) int arrays; :func:`pattern_frames` wraps them into
real WIBEth frames with faked timestamps for processor-level tests.
"""

from __future__ import annotations

import numpy as np

from ..formats import wibeth

GOLDEN_ADCS = np.array([500, 502, 504, 505, 506, 505, 504, 502, 500])
GOLDEN_THRESHOLD = 499   # recommended threshold for the golden pattern


def golden(n_frames: int = 2, channel: int = 0, offset: int = 1,
           n_channels: int = 64, frame_ticks: int = 64,
           pedestal: int = 0) -> np.ndarray:
    """One golden hill per frame on `channel`, starting at `offset` ticks
    into each frame (offset in [1, 63])."""
    T = n_frames * frame_ticks
    adcs = np.full((T, n_channels), pedestal, dtype=np.int32)
    for f in range(n_frames):
        t0 = f * frame_ticks + offset
        seg = GOLDEN_ADCS[: max(0, min(len(GOLDEN_ADCS), T - t0))]
        adcs[t0:t0 + len(seg), channel] = pedestal + seg
    return adcs


def pulse(n_frames: int = 2, channel: int = 0, tick: int = 10,
          amplitude: int = 5000, n_channels: int = 64,
          frame_ticks: int = 64, pedestal: int = 0) -> np.ndarray:
    T = n_frames * frame_ticks
    adcs = np.full((T, n_channels), pedestal, dtype=np.int32)
    adcs[tick, channel] = pedestal + amplitude
    return adcs


def edge_square(n_frames: int = 2, channel: int = 0, width: int = 16,
                amplitude: int = 1000, n_channels: int = 64,
                frame_ticks: int = 64, pedestal: int = 0) -> np.ndarray:
    """Square pulse centered on the boundary between frames 0 and 1."""
    T = n_frames * frame_ticks
    adcs = np.full((T, n_channels), pedestal, dtype=np.int32)
    t0 = frame_ticks - width // 2
    adcs[t0:t0 + width, channel] = pedestal + amplitude
    return adcs


def _edge_triangle(peak_tick: int, half: int, amplitude: int, T: int,
                   channel: int, n_channels: int, pedestal: int) -> np.ndarray:
    adcs = np.full((T, n_channels), pedestal, dtype=np.int32)
    for i in range(-half, half + 1):
        t = peak_tick + i
        if 0 <= t < T:
            adcs[t, channel] = pedestal + amplitude * (half + 1 - abs(i)) // (half + 1)
    return adcs


def edge_left(n_frames: int = 2, channel: int = 0, amplitude: int = 1000,
              half: int = 8, n_channels: int = 64, frame_ticks: int = 64,
              pedestal: int = 0) -> np.ndarray:
    """Triangular pulse spanning the frame boundary, peak in frame 0."""
    return _edge_triangle(frame_ticks - 3, half, amplitude,
                          n_frames * frame_ticks, channel, n_channels, pedestal)


def edge_right(n_frames: int = 2, channel: int = 0, amplitude: int = 1000,
               half: int = 8, n_channels: int = 64, frame_ticks: int = 64,
               pedestal: int = 0) -> np.ndarray:
    """Triangular pulse spanning the frame boundary, peak in frame 1."""
    return _edge_triangle(frame_ticks + 2, half, amplitude,
                          n_frames * frame_ticks, channel, n_channels, pedestal)


PATTERNS = {
    "golden": golden,
    "pulse": pulse,
    "edge_square": edge_square,
    "edge_left": edge_left,
    "edge_right": edge_right,
}


def pattern_frames(name: str, first_timestamp: int = 0, crate_id: int = 0,
                   slot_id: int = 0, stream_id: int = 0, **kw):
    """Generate real WIBEth frames holding the pattern.

    Returns (frames (n, 7200) uint8, adcs (T, 64) int32).
    """
    adcs = PATTERNS[name](**kw)
    T = adcs.shape[0]
    n_frames = T // wibeth.N_TIME_SAMPLES
    frames = wibeth.empty_frames(n_frames)
    wibeth.set_adcs(frames, adcs.reshape(n_frames, wibeth.N_TIME_SAMPLES, -1)
                    .astype(np.uint16))
    wibeth.fake_timestamps(frames, first_timestamp)
    wibeth.fake_geoid(frames, crate_id, slot_id, stream_id)
    wibeth.fake_seq_ids(frames, 0)
    return frames, adcs
