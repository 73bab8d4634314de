"""Source emulation: file replay, rate limiting, fake sources.

Port copy of ``fdreadoutlibs_tpu/stream/emulator.py:1-140``
(numpy on the port's ``stream/transport.Sender``); the code is
unchanged.

Equivalents of the readoutlibs pieces the reference exercises
(SURVEY.md §2.4/§2.6): ``FileSourceBuffer`` (load a binary frame file),
``RateLimiter`` (pace payload delivery), and ``TPEmulatorModel``-style
replay onto a sink (wib/TPEmulatorModel.hpp:107-174), plus generators for
the documented validation inputs (the all-zeros WIBEth file and the
pattern files, docs/README.md:69-146).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..formats import wibeth
from ..ops import patterns
from .transport import Sender


class FileSourceBuffer:
    """Load fixed-size payloads from a binary file (readoutlibs
    FileSourceBuffer equivalent)."""

    def __init__(self, payload_size: int):
        self.payload_size = payload_size
        self._payloads: Optional[np.ndarray] = None

    def read(self, path) -> np.ndarray:
        data = np.fromfile(str(path), dtype=np.uint8)
        n = len(data) // self.payload_size
        if n == 0:
            raise ValueError(f"{path}: no complete {self.payload_size}-byte "
                             "payloads")
        self._payloads = data[: n * self.payload_size].reshape(
            n, self.payload_size)
        return self._payloads

    @property
    def payloads(self) -> np.ndarray:
        if self._payloads is None:
            raise RuntimeError("no file loaded")
        return self._payloads

    def __len__(self) -> int:
        return 0 if self._payloads is None else len(self._payloads)


class RateLimiter:
    """Pace an emitting loop at a fixed payload rate (readoutlibs
    RateLimiter equivalent — kHz granularity, adjustable on the fly)."""

    def __init__(self, rate_hz: float):
        self.rate_hz = rate_hz
        self._next = time.monotonic()

    def limit(self) -> None:
        period = 1.0 / self.rate_hz
        now = time.monotonic()
        if self._next > now:
            time.sleep(self._next - now)
        self._next = max(self._next + period, now - 0.1)

    def adjust(self, rate_hz: float) -> None:
        self.rate_hz = rate_hz


class SourceEmulator:
    """Replay payloads from a buffer to a sink at a configured rate with
    looping and timestamp patching (TPEmulatorModel.hpp:107-174)."""

    def __init__(self, sink: Sender, adapter=None):
        self.sink = sink
        self.adapter = adapter
        self.conf_rate_hz = 1000.0
        self.batch_size = 64
        self.packets_sent = 0
        self.packets_dropped = 0
        self._running = False

    def conf(self, config: dict) -> None:
        self.conf_rate_hz = config.get("rate_hz", 1000.0)
        self.batch_size = config.get("batch_size", 64)

    def run(self, payloads: np.ndarray, n_batches: int,
            first_timestamp: int = 0, tick_per_payload: int | None = None):
        """Send n_batches batches, looping over payloads, with perfectly
        incrementing timestamps when an adapter is attached."""
        limiter = RateLimiter(self.conf_rate_hz / self.batch_size)
        n = len(payloads)
        ts = first_timestamp
        idx = 0
        for _ in range(n_batches):
            take = min(self.batch_size, n)
            rows = np.take(payloads, np.arange(idx, idx + take) % n, axis=0)
            rows = np.ascontiguousarray(rows)
            idx = (idx + take) % n
            if self.adapter is not None and tick_per_payload:
                tss = ts + np.arange(take, dtype=np.uint64) * tick_per_payload
                self.adapter.set_first_timestamp(rows, tss)
                ts += take * tick_per_payload
            if self.sink.try_send(rows):
                self.packets_sent += take
            else:
                self.packets_dropped += take
            limiter.limit()


# ---- documented validation inputs ----------------------------------------------

def all_zeros_wibeth_file(path, n_frames: int = 32,
                          first_timestamp: int = 0x66583B8C7E967) -> Path:
    """Generate the `wibeth_output_all_zeros.bin` asset: 32 all-zero WIBEth
    frames with delta-ts 2048 (docs/README.md:74-82)."""
    frames = wibeth.empty_frames(n_frames)
    wibeth.fake_timestamps(frames, first_timestamp)
    wibeth.fake_seq_ids(frames, 0)
    frames.tofile(str(path))
    return Path(path)


def pattern_file(path, name: str, n_frames: int = 2, channel: int = 0,
                 offset: int = 1, first_timestamp: int = 0x66583B8C7E967,
                 **kw) -> Path:
    """Generate a pattern binary (wibeth_tpg_pattern_generator equivalent,
    docs/README.md:93-121): golden / pulse / edge_square / edge_left /
    edge_right.  ``offset`` maps to the golden hit start tick / pulse tick."""
    args = dict(first_timestamp=first_timestamp, n_frames=n_frames,
                channel=channel, **kw)
    if name == "golden":
        args["offset"] = offset
    elif name == "pulse":
        args["tick"] = offset
    frames, _ = patterns.pattern_frames(name, **args)
    wibeth.fake_seq_ids(frames, 0)
    frames.tofile(str(path))
    return Path(path)
