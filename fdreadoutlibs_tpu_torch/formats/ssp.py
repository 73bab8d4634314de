"""SSP photon-detector event format.

Port copy of ``fdreadoutlibs_tpu/formats/ssp.py:1-73``: the same code apart from
imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Geometry (reference: include/fdreadoutlibs/SSPFrameTypeAdapter.hpp:18-57):
an SSP payload = ssp::EventHeader + 1012 bytes of waveform data.  The
EventHeader layout follows dunedaq SSPTypes: all 16/32-bit little-endian
fields; the 64-bit timestamp is split across FOUR 16-bit words
(hpp:40-57 — ts = sum(timestamp[i] << 16*i)).
"""

from __future__ import annotations

import numpy as np

EVENT_HEADER_DTYPE = np.dtype([
    ("header", "<u4"),          # 0xAAAAAAAA sync word
    ("length", "<u2"),
    ("group1", "<u2"),
    ("triggerID", "<u2"),
    ("group2", "<u2"),
    ("timestamp", "<u2", (4,)),
    ("peakSumLow", "<u2"),
    ("group3", "<u2"),
    ("preriseLow", "<u2"),
    ("group4", "<u2"),
    ("intSum", "<u4"),
    ("baseline", "<u2"),
    ("cfdPoint", "<u2", (4,)),
    ("intTimestamp", "<u2", (4,)),
    # the C++ ssp::EventHeader has 4-byte alignment (uint members), so
    # sizeof == 52, not the 50 bytes of fields: the DAQ's byte stream
    # carries 2 trailing pad bytes before the waveform data
    ("_pad", "<u2"),
])

HEADER_SIZE = EVENT_HEADER_DTYPE.itemsize
assert HEADER_SIZE == 52  # sizeof(fddetdataformats::ssp::EventHeader)
PAYLOAD_SIZE = 1012                 # kSSPFrameSize (hpp:18)
FRAME_SIZE = HEADER_SIZE + PAYLOAD_SIZE
FRAGMENT_TYPE = "kPDSData"


def empty_frames(n: int = 1) -> np.ndarray:
    return np.zeros((n, FRAME_SIZE), dtype=np.uint8)


def headers(frames: np.ndarray) -> np.ndarray:
    return frames[..., :HEADER_SIZE].view(EVENT_HEADER_DTYPE).reshape(
        frames.shape[:-1])


def get_timestamp(frames: np.ndarray) -> np.ndarray:
    """ts = sum(timestamp[i] << 16*i) (hpp:36-47)."""
    words = headers(frames)["timestamp"].astype(np.uint64)
    shifts = np.uint64(16) * np.arange(4, dtype=np.uint64)
    return (words << shifts).sum(axis=-1, dtype=np.uint64)


def set_timestamp(frames: np.ndarray, ts) -> None:
    h = headers(frames)
    ts = np.asarray(ts, dtype=np.uint64)
    for i in range(4):
        h["timestamp"][..., i] = ((ts >> np.uint64(16 * i))
                                  & np.uint64(0xFFFF)).astype(np.uint16)


def get_waveform(frames: np.ndarray) -> np.ndarray:
    """Payload as (..., 506) uint16 waveform samples."""
    return frames[..., HEADER_SIZE:].view("<u2").copy()


def set_waveform(frames: np.ndarray, samples) -> None:
    frames[..., HEADER_SIZE:].view("<u2")[...] = \
        np.asarray(samples, dtype=np.uint16)
