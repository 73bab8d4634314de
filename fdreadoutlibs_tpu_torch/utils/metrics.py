"""Metrics collection (≈ opmonlib::InfoCollector + RawDataProcessorInfo).

Copied from ``fdreadoutlibs_tpu/utils/metrics.py:1-101``; the code is
unchanged.

Counters mirror the reference's info structs (WIBEthFrameProcessor.cpp:
238-292, TPCTPRequestHandler.cpp:58-82): sequence/timestamp error counters,
min/max seq jumps, hit/TP rates, send failures, suppressed-too-long counts,
heartbeats, and the per-channel TP-rate map whose top-10 feeds monitoring.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np


class MetricsCollector:
    def __init__(self):
        self._counters: dict[str, int] = defaultdict(int)
        self._gauges: dict[str, float] = {}
        self.channel_tp_counts: dict[int, int] = defaultdict(int)
        self._channel_pending: list[np.ndarray] = []
        # Guards _channel_pending AND channel_tp_counts (consolidation's
        # read-modify-write, top_channels iteration, reset clear): the
        # batch thread appends while a monitoring thread consolidates;
        # uncontended acquire is ~100 ns, negligible at per-batch cadence.
        self._channel_lock = threading.Lock()
        self._t0 = time.monotonic()

    # counters -----------------------------------------------------------
    def inc(self, name: str, amount: int = 1) -> None:
        self._counters[name] += amount

    def set_max(self, name: str, value) -> None:
        self._gauges[name] = max(self._gauges.get(name, value), value)

    def set_min(self, name: str, value) -> None:
        self._gauges[name] = min(self._gauges.get(name, value), value)

    def count(self, name: str) -> int:
        return self._counters[name]

    def gauge(self, name: str):
        return self._gauges.get(name)

    def add_channel_tps(self, channels) -> None:
        """Accumulate per-channel TP counts.  O(1) append on the hot
        path: the per-batch np.unique + dict merge was the largest cost
        of the batched APA TP assembly (bench_tp_path); consolidation is
        deferred to the (rare) top_channels/get_info queries."""
        arr = np.asarray(channels)
        if len(arr):
            with self._channel_lock:
                self._channel_pending.append(arr.copy())

    def _consolidate_channels(self) -> None:
        # the channel_tp_counts read-modify-write stays under the lock:
        # two concurrent consolidations (monitoring get_info racing a
        # top_channels call) would otherwise lose counts.  add_channel_tps
        # (the hot path) still only pays the pending-list append.
        with self._channel_lock:
            if not self._channel_pending:
                return
            pending, self._channel_pending = self._channel_pending, []
            allc = pending[0] if len(pending) == 1 \
                else np.concatenate(pending)
            chans, counts = np.unique(allc, return_counts=True)
            for c, n in zip(chans.tolist(), counts.tolist()):
                self.channel_tp_counts[c] += n

    def top_channels(self, n: int = 10) -> list[tuple[int, int]]:
        """Top-n (channel, tp_count) — WIBEthFrameProcessor.cpp:264-287."""
        self._consolidate_channels()
        # iterate under the same lock the consolidation mutates under: a
        # concurrent consolidation inserting a first-seen channel would
        # otherwise resize the dict mid-sorted() (RuntimeError)
        with self._channel_lock:
            return sorted(self.channel_tp_counts.items(),
                          key=lambda kv: -kv[1])[:n]

    # snapshot (get_info equivalent) -------------------------------------
    def get_info(self) -> dict:
        now = time.monotonic()
        seconds = max(now - self._t0, 1e-9)
        info = dict(self._counters)
        info.update(self._gauges)
        info["rate_tp_hits_khz"] = self._counters.get("num_hits", 0) / seconds / 1e3
        info["interval_seconds"] = seconds
        info["top_channels"] = self.top_channels()
        return info

    def reset_interval(self) -> dict:
        """Snapshot and reset rate counters (the exchange(0) pattern)."""
        info = self.get_info()
        self._counters.clear()
        with self._channel_lock:
            self.channel_tp_counts.clear()
            self._channel_pending = []
        self._t0 = time.monotonic()
        return info
