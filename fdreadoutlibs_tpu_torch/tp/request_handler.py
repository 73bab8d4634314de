"""TP request handler: TPSet windowing, heartbeats, cutoff, data requests.

Port copy of ``fdreadoutlibs_tpu/tp/request_handler.py``: identical code apart
from imports; ``request_fragment`` (the Fragment/wire path) is left out.

Equivalent of TPCTPRequestHandler (src/TPCTPRequestHandler.cpp): a sender
loop windows buffered TPs into ``trigger::TPSet``s at a configured rate with
a latency margin, emits heartbeats for empty windows, maintains the cutoff
timestamp that rejects tardy TPs upstream, and serves windowed data
requests from the same buffer.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..formats.trigprim import TPSet, TPSetType
from ..utils.metrics import MetricsCollector

from .latency_buffer import LatencyBuffer

TICKS_PER_MS = 62_500  # 62.5 MHz clock (TPCTPRequestHandler.cpp:93)


class TPRequestHandler:

    def __init__(self, tpset_sink=None, latency_buffer: Optional[LatencyBuffer] = None):
        self.tpset_sink = tpset_sink
        self.buffer = latency_buffer or LatencyBuffer()
        self.metrics = MetricsCollector()
        self._thread: Optional[threading.Thread] = None
        self._run_marker = False

    # -- lifecycle (cpp:8-55) -------------------------------------------
    def conf(self, config: dict) -> None:
        """Keys mirror ReadoutModelConf (cpp:20-27)."""
        self.source_id = config.get("tpset_sourceid", config.get("source_id", 0))
        rate = config.get("tpset_transmission_rate_hz", 200)
        self.sender_sleep_us = 1_000_000 // rate
        self.min_latency_ticks = config.get("tpset_min_latency_ticks", 3125 * 32)
        self.tardy_quiet_time_sec = config.get(
            "tardy_tp_quiet_time_at_start_sec", 10)
        # A fully quiet link still ticks: the window clock advances on the
        # newest OBSERVED stream timestamp (note_stream_time, fed from
        # frame headers) so downstream trigger aggregation keeps receiving
        # kHeartbeat TPSets even with zero TPs buffered.  (The reference's
        # sender loop idles when its buffer is empty,
        # TPCTPRequestHandler.cpp:115 — a deliberate improvement here.)
        # Deliberately NOT wall-clock extrapolated: a source slower than
        # real time (file replay, a wedged upstream) must not let the
        # cutoff race ahead of stream time and tardy-drop real TPs.
        self.emit_heartbeats_when_empty = config.get(
            "emit_heartbeats_when_empty", True)

    def start(self, run_number: int = 0) -> None:
        self.run_number = run_number
        self.cutoff_timestamp = 0
        self.next_tpset_seqno = 0
        self._start_win_ts = None
        self._last_stream_ts = None   # newest observed stream timestamp
        self._first_stream_ts = None  # first observed (zero-TP window seed)
        self._run_start = time.monotonic()
        self.metrics.reset_interval()
        self._run_marker = True

    def stop(self) -> None:
        self._run_marker = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.cutoff_timestamp = 0

    # -- TP ingress with tardy suppression (cpp:85-97) -------------------
    def insert_tps(self, tps: np.ndarray) -> int:
        """Insert TPs; those older than the cutoff timestamp are tardy and
        suppressed (the reference rejects them upstream via
        supports_cutoff_timestamp, hpp:81-83)."""
        if len(tps) == 0:
            return 0
        tardy = tps["time_start"] < np.uint64(self.cutoff_timestamp)
        n_tardy = int(tardy.sum())
        if n_tardy:
            self.metrics.inc("num_tps_suppressed_tardy", n_tardy)
            quiet = (time.monotonic() - self._run_start) < self.tardy_quiet_time_sec
            if not quiet:
                worst = int(np.uint64(self.cutoff_timestamp)
                            - tps["time_start"][tardy].min())
                self.metrics.set_max("max_tardy_ms", worst / TICKS_PER_MS)
            tps = tps[~tardy]
        return self.buffer.insert(tps)

    def note_stream_time(self, ts: int) -> None:
        """Advance the heartbeat clock to an observed stream timestamp (the
        newest frame timestamp of a processed batch): a link that has
        produced ZERO TPs — or whose buffered TPs are stale — then still
        emits monotonically advancing kHeartbeat TPSets, keeping downstream
        trigger aggregation moving.

        Deliberately does NOT seed the window start: ``ts`` is a batch-END
        timestamp, and seeding the start from it would exclude every TP of
        the first batch.  send_tp_sets_once seeds the start from the oldest
        buffered TP (reference semantics, TPCTPRequestHandler.cpp:127-129),
        falling back to the FIRST observed stream timestamp for zero-TP
        links."""
        ts = int(ts)
        if self._last_stream_ts is None or ts > self._last_stream_ts:
            self._last_stream_ts = ts
        if self._first_stream_ts is None:
            self._first_stream_ts = ts

    # -- TPSet emission (cpp:100-193) ------------------------------------
    def send_tp_sets_once(self) -> Optional[TPSet]:
        """One cycle of the sender loop; returns the TPSet if one was due.

        The window clock is max(newest buffered TP, newest observed stream
        timestamp from note_stream_time) — so a quiet link (no TPs at all,
        or only stale already-shipped ones retained for data requests)
        keeps emitting monotonically advancing kHeartbeat TPSets, gated by
        config ``emit_heartbeats_when_empty``.  Never wall-clock
        extrapolated: the cutoff must not race ahead of stream time."""
        newest = None
        if self.buffer.occupancy() != 0:
            newest = self.buffer.newest_ts()
            if self._start_win_ts is None:
                self._start_win_ts = self.buffer.oldest_ts()
        if getattr(self, "emit_heartbeats_when_empty", True) and \
                self._last_stream_ts is not None:
            newest = self._last_stream_ts if newest is None \
                else max(newest, self._last_stream_ts)
            if self._start_win_ts is None:
                # zero-TP link: the window starts at the FIRST observed
                # stream timestamp (note_stream_time docs)
                self._start_win_ts = self._first_stream_ts
        if newest is None or self._start_win_ts is None:
            return None
        if newest - self._start_win_ts <= self.min_latency_ticks:
            return None
        end_win_ts = newest - self.min_latency_ticks
        tps = self.buffer.extract_window(self._start_win_ts, end_win_ts)

        tpset = TPSet(
            run_number=self.run_number,
            type=TPSetType.kPayload if len(tps) else TPSetType.kHeartbeat,
            origin=self.source_id,
            start_time=self._start_win_ts,
            end_time=end_win_ts,
            seqno=self.next_tpset_seqno,
            objects=tps,
        )
        self.next_tpset_seqno += 1
        if len(tps):
            # provisional window times replaced by first/last TP (cpp:156-164)
            tpset.start_time = int(tps["time_start"][0])
            tpset.end_time = int(tps["time_start"][-1])
        self.cutoff_timestamp = tpset.end_time

        sent = True
        if self.tpset_sink is not None:
            sent = self.tpset_sink.try_send(tpset)
        if not sent:
            self.metrics.inc("num_tpsets_send_failed")
            self.metrics.inc("num_tps_in_tpsets_send_failed", len(tps))
        else:
            self.metrics.inc("num_tpsets_sent")
            self.metrics.inc("num_tps_sent", len(tps))
            if len(tps) == 0:
                self.metrics.inc("num_heartbeats")
        # advance the window (cpp:181); shipped TPs REMAIN buffered for the
        # data-request path — cleanup is a separate policy (see cleanup())
        self._start_win_ts = end_win_ts
        return tpset

    # -- cleanup (DefaultSkipListRequestHandler / DAPHNE override) -------
    def cleanup(self, max_occupancy: int | None = None,
                max_ts_diff: int | None = None) -> int:
        """Trim the buffer: by occupancy (pop oldest beyond max_occupancy)
        and/or by time span (DAPHNEListRequestHandler.cpp:37-50)."""
        dropped = 0
        if max_ts_diff is not None:
            dropped += self.buffer.cleanup_max_ts_diff(max_ts_diff)
        if max_occupancy is not None:
            excess = self.buffer.occupancy() - max_occupancy
            if excess > 0:
                # exact-count trim (no snapshot; duplicate-key safe)
                dropped += self.buffer.pop_n(excess)
        if dropped:
            self.metrics.inc("num_tps_cleaned", dropped)
        return dropped

    # -- background sender thread (ReusableThread, cpp:43) ---------------
    def start_sender_thread(self) -> None:
        def loop():
            while self._run_marker:
                self.send_tp_sets_once()
                time.sleep(self.sender_sleep_us / 1e6)
        self._thread = threading.Thread(target=loop, name="tpset-sender",
                                        daemon=True)
        self._thread.start()

    # -- windowed data requests (DefaultSkipListRequestHandler path) -----
    def request(self, start_ts: int, end_ts: int) -> np.ndarray:
        """Serve a data request: all buffered TPs in [start_ts, end_ts)."""
        self.metrics.inc("num_requests")
        return self.buffer.extract_window(start_ts, end_ts)

    def get_info(self) -> dict:
        info = self.metrics.get_info()
        info["buffer_occupancy"] = self.buffer.occupancy()
        return info
