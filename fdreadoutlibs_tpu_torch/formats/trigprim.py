"""TriggerPrimitive / TPSet records.

Port copy of ``fdreadoutlibs_tpu/formats/trigprim.py``: the same code apart
from imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Mirrors ``trgdataformats::TriggerPrimitive`` as consumed by the reference TP
assembly (src/wibeth/WIBEthFrameProcessor.cpp:539-549) and
``trigger::TPSet`` as built by TPCTPRequestHandler
(src/TPCTPRequestHandler.cpp:145-165).  TPs are stored as a numpy structured
array so host-side buffering/windowing is vectorized; a TP stream is just a
(N,) array of TP_DTYPE.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

__all__ = ["TP_DTYPE", "TPType", "TPAlgorithm", "TPSet", "TPSetType",
           "make_tps", "sort_tps"]


class TPType(IntEnum):
    kUnknown = 0
    kTPC = 1
    kPDS = 2


class TPAlgorithm(IntEnum):
    kUnknown = 0
    kSimpleThreshold = 1
    kAbsRunningSum = 2
    kRunningSum = 3


# trgdataformats::TriggerPrimitive field set (see WIBEthFrameProcessor.cpp:539-549)
TP_DTYPE = np.dtype([
    ("time_start", np.uint64),
    ("time_peak", np.uint64),
    ("time_over_threshold", np.uint64),
    ("channel", np.int32),
    ("adc_integral", np.uint32),
    ("adc_peak", np.uint32),
    ("detid", np.uint16),
    ("type", np.uint16),
    ("algorithm", np.uint16),
    ("version", np.uint16),
    ("flag", np.uint16),
])


def ts_to_i64(ts) -> np.int64:
    """Reinterpret a uint64 DAQ timestamp as two's-complement int64.

    TP assembly does signed arithmetic around the frame timestamp
    (t_begin = ts + 32*(end - tover)); the reference does it in native
    uint64 which silently wraps.  A corrupted header can carry ts >= 2^63,
    and np.int64(ts) raises OverflowError instead of wrapping — found by
    scripts/fuzz_frames.py.  This reinterpretation keeps the final
    .astype(np.uint64) stores bit-identical to uint64 arithmetic.

    Accepts scalars and ndarrays (arrays are reinterpreted via
    uint64.view(int64) — same bits, vectorized)."""
    if isinstance(ts, np.ndarray):
        return ts.astype(np.uint64, copy=False).view(np.int64)
    ts = int(ts) & 0xFFFFFFFFFFFFFFFF
    return np.int64(ts - (1 << 64) if ts >= (1 << 63) else ts)


def make_tps(n: int) -> np.ndarray:
    tps = np.zeros(n, dtype=TP_DTYPE)
    tps["version"] = 1
    return tps


def sort_tps(tps: np.ndarray) -> np.ndarray:
    """Canonical TP ordering: (time_start, channel) — the adapter's operator<
    (TriggerPrimitiveTypeAdapter.hpp:26-29)."""
    order = np.lexsort((tps["channel"], tps["time_start"]))
    return tps[order]


class TPSetType(IntEnum):
    kUnknown = 0
    kPayload = 1
    kHeartbeat = 2


@dataclass
class TPSet:
    """trigger::TPSet equivalent (TPCTPRequestHandler.cpp:145-165)."""
    run_number: int = 0
    type: TPSetType = TPSetType.kUnknown
    origin: int = 0              # SourceID id
    start_time: int = 0
    end_time: int = 0
    seqno: int = 0
    objects: np.ndarray = field(default_factory=lambda: make_tps(0))

    def __len__(self) -> int:
        return len(self.objects)
