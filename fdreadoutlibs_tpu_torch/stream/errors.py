"""Error registry and issue types.

Port copy of ``fdreadoutlibs_tpu/stream/errors.py``: the same code apart
from imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Mirrors the reference's ERS issues (FDReadoutIssues.hpp:27-46,
TPCTPRequestHandler.hpp:34-53) and readoutlibs::FrameErrorRegistry as
lightweight Python exceptions/records routed through the metrics layer
instead of an external logging stack.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass

log = logging.getLogger("fdreadoutlibs_tpu")


class FDReadoutError(Exception):
    """Base for reportable (non-fatal) conditions; mirrors ERS warnings."""


class TPGAlgorithmInexistent(FDReadoutError):
    """FDReadoutIssues.hpp: requested TPG algorithm does not exist."""


class TPTooLong(FDReadoutError):
    """FDReadoutIssues.hpp: TP time-over-threshold exceeds tp_timeout."""


class FailedToSendTP(FDReadoutError):
    """FDReadoutIssues.hpp: non-blocking TP send failed."""


class FailedToSendTPSet(FDReadoutError):
    pass


class LinkMisconfiguration(FDReadoutError):
    """Frame header crate/slot/stream disagrees with configuration
    (WIBEthFrameProcessor.cpp:430-432)."""


class DataPacketArrivedTooLate(FDReadoutError):
    """TP older than the TPSet cutoff timestamp (TPCTPRequestHandler.cpp:85-97)."""


@dataclass
class ErrorInterval:
    """FrameErrorRegistry::ErrorInterval — [start, end) of the error."""
    start: int
    end: int
    time: float = 0.0


class FrameErrorRegistry:
    """readoutlibs::FrameErrorRegistry equivalent: named error streams with
    bounded history (used by 'MISSING_FRAMES' / 'SEQUENCE_ID_JUMP',
    WIBEthFrameProcessor.cpp:336, 388)."""

    def __init__(self, max_history: int = 1000):
        self._errors: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_history))
        self._counts: dict[str, int] = defaultdict(int)

    def add_error(self, name: str, interval: ErrorInterval) -> None:
        interval.time = time.monotonic()
        self._errors[name].append(interval)
        self._counts[name] += 1

    def has_error(self, name: str) -> bool:
        return self._counts[name] > 0

    def error_count(self, name: str | None = None) -> int:
        if name is None:
            return sum(self._counts.values())
        return self._counts[name]

    def recent(self, name: str) -> list[ErrorInterval]:
        return list(self._errors[name])
