"""Raw-payload readout buffering + windowed data requests.

Port copy of ``fdreadoutlibs_tpu/tp/readout_buffer.py``: identical code apart
from imports.

The reference's request handlers serve *raw payload* windows from latency
buffers for trigger readout (DefaultRequestHandlerModel /
DefaultSkipListRequestHandler; exercised via DAPHNEListRequestHandler and
TPCTPRequestHandler's shared get_fragment_pieces path).  Here raw payloads
(frames/superchunks as byte rows) are stored in the same ordered-buffer
machinery, keyed by the adapter's first timestamp, and served as fragments.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..formats.adapters import TypeAdapter
from ..utils.metrics import MetricsCollector

from .latency_buffer import _exact_key, make_latency_buffer


def payload_record_dtype(payload_size: int) -> np.dtype:
    """Records of (key timestamp, raw payload bytes) — native-buffer ready
    (the uint64 key leads)."""
    return np.dtype([("time_start", np.uint64),
                     ("payload", np.uint8, (payload_size,))])


class PayloadRingBuffer:
    """Ordered retention buffer specialized for FIXED-SIZE, time-ordered
    raw payload streams (the per-link readout case).

    The general ordered buffers (LatencyBuffer / the native arena) pay a
    record-interleave copy plus per-record insertion; for raw payloads
    that made retention the dominant host cost — ~0.9 GB/s against an
    8.8 GB/s/APA raw stream (scripts/bench_tp_path.py apa_host_loop).
    Raw links arrive already time-ordered (sequence/timestamp checks run
    upstream), so ordered retention needs no sorting at all: a compacting
    linear buffer with separate contiguous key/payload arrays gives
    one-memcpy insert at numpy copy speed, pointer-advance pops, and
    direct searchsorted window queries.  When appends reach the array end
    the live region is memmoved to the front — amortized O(1) because the
    array holds 2x the live capacity.

    Key monotonicity: keys are clamped to be non-decreasing on insert
    (np.maximum.accumulate against the newest buffered key).  A frame
    whose header timestamp jumps BACKWARD was already flagged by the
    upstream timestamp check; clamping keeps window queries well-defined
    instead of silently corrupting the order invariant.
    Thread-safe like the other buffers (one lock; the data-request
    service may read while the batch loop inserts).
    """

    def __init__(self, payload_size: int, capacity: int | None = None,
                 pretouch: bool = True):
        self.payload_size = int(payload_size)
        self.capacity = capacity
        rows = 2 * capacity if capacity else 256
        self._keys = np.zeros(rows, dtype=np.uint64)
        self._data = np.zeros((rows, self.payload_size), dtype=np.uint8)
        if capacity and pretouch:
            # fault the arena pages in NOW: without this the first pass
            # through a bounded arena runs at page-fault speed (~1.5 GB/s
            # measured) instead of memcpy speed (~6.7 GB/s), i.e. the
            # first seconds of a run are the slowest — the opposite of
            # what a DAQ wants.  One write per 4 KiB page suffices.
            self._data[:, ::4096] = 0
            self._data[:, -1] = 0
        self._start = 0
        self._end = 0
        self._lock = threading.RLock()
        self.total_inserted = 0
        # Backward-jumping keys are clamped on insert (class docstring);
        # the substitution is silent to fragment consumers, so count it —
        # operators correlate data-request anomalies with upstream
        # timestamp errors via this counter (surfaced in handler metrics).
        self.num_keys_clamped = 0

    def _live(self) -> int:
        return self._end - self._start

    def _make_room(self, n: int) -> None:
        rows = len(self._keys)
        if self._end + n <= rows:
            return
        live = self._live()
        if live + n > rows:
            # unbounded buffer: grow geometrically
            new_rows = max(2 * rows, 2 * (live + n))
            keys = np.zeros(new_rows, dtype=np.uint64)
            data = np.zeros((new_rows, self.payload_size), np.uint8)
            keys[:live] = self._keys[self._start:self._end]
            data[:live] = self._data[self._start:self._end]
            self._keys, self._data = keys, data
        else:
            # compact the live region to the front (amortized: the array
            # holds >= 2x the live rows).  The .copy() avoids overlapping
            # same-array slice assignment, which numpy does not guarantee.
            self._keys[:live] = self._keys[self._start:self._end].copy()
            self._data[:live] = self._data[self._start:self._end].copy()
        self._start, self._end = 0, live

    def insert(self, keys: np.ndarray, payloads: np.ndarray) -> int:
        n = len(keys)
        if n == 0:
            return 0
        with self._lock:
            if self.capacity is not None:
                room = self.capacity - self._live()
                if room <= 0:
                    return 0
                if n > room:
                    keys, payloads, n = keys[:room], payloads[:room], room
            self._make_room(n)
            raw = np.asarray(keys, dtype=np.uint64)
            keys = np.maximum.accumulate(raw)
            if self._live() and keys[0] < self._keys[self._end - 1]:
                keys = np.maximum(keys, self._keys[self._end - 1])
            self.num_keys_clamped += int(np.count_nonzero(keys != raw))
            self._keys[self._end:self._end + n] = keys
            self._data[self._end:self._end + n] = payloads
            self._end += n
            self.total_inserted += n
            return n

    # -- queries ----------------------------------------------------------
    def occupancy(self) -> int:
        with self._lock:
            return self._live()

    def oldest_ts(self):
        with self._lock:
            return int(self._keys[self._start]) if self._live() else None

    def newest_ts(self):
        with self._lock:
            return int(self._keys[self._end - 1]) if self._live() else None

    def key_at(self, idx: int):
        with self._lock:
            if idx >= self._live():
                return None
            return int(self._keys[self._start + idx])

    def _window_bounds(self, start_ts: int, end_ts: int) -> tuple[int, int]:
        k = self._keys[self._start:self._end]
        # exact saturating boundary coercion: searchsorted(uint64, int)
        # promotes through float64, lossy above 2**53 (same bug class as
        # LatencyBuffer._exact_key; scripts/fuzz_tp_path.py)
        lo = int(np.searchsorted(k, _exact_key(start_ts, k.dtype),
                                 side="left"))
        hi = int(np.searchsorted(k, _exact_key(end_ts, k.dtype),
                                 side="left"))
        return self._start + lo, self._start + hi

    def extract_window(self, start_ts: int, end_ts: int) -> np.ndarray:
        """Payload rows with start_ts <= key < end_ts (non-consuming)."""
        with self._lock:
            lo, hi = self._window_bounds(start_ts, end_ts)
            return self._data[lo:hi].copy()

    def extract_window_keys(self, start_ts: int, end_ts: int) -> np.ndarray:
        with self._lock:
            lo, hi = self._window_bounds(start_ts, end_ts)
            return self._keys[lo:hi].copy()

    # -- cleanup ------------------------------------------------------------
    def pop_until(self, ts: int) -> int:
        with self._lock:
            lo, _ = self._window_bounds(ts, ts)
            dropped = lo - self._start
            self._start = lo
            return dropped

    def pop_n(self, n: int) -> int:
        with self._lock:
            n = min(int(n), self._live())
            if n <= 0:          # a negative n must not resurrect popped rows
                return 0
            self._start += n
            return n

    def cleanup_max_ts_diff(self, max_ts_diff: int) -> int:
        with self._lock:
            if not self._live():
                return 0
            return self.pop_until(int(self._keys[self._end - 1])
                                  - int(max_ts_diff))

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._data[self._start:self._end].copy()


class SegmentedPayloadBuffer:
    """ZERO-COPY ordered retention for fixed-size, time-ordered payload
    streams: insert stores a *reference* to the caller's payload rows
    instead of copying them into an arena.

    Raw retention was the largest residual host cost per APA after the
    PayloadRingBuffer work — ~1.3 cores of pure memcpy against the
    8.8 GB/s/APA raw stream at this box's 6.7 GB/s copy speed
    (scripts/bench_tp_path.py apa_host_loop; VERDICT r3 #4).  The
    reference avoids that cost structurally: readoutlibs'
    IterableQueueModel pre-allocates the latency buffer and the NIC/
    emulator writes payloads *in place*, so retention is free.  The
    TPU-native equivalent is segment leasing: the producer hands each
    batch slab to the buffer (insert = append a (keys, rows-view)
    segment, O(1) plus a small key clamp), and the buffer drops the
    reference on eviction.

    OWNERSHIP CONTRACT: the caller must not mutate payload rows after
    insert (the emulator/app allocate a fresh slab per batch; a NIC
    card hands off filled ring slots the same way).  Callers that
    recycle and overwrite their buffers need the copying
    :class:`PayloadRingBuffer` instead.

    Queries behave exactly like PayloadRingBuffer (same key clamping,
    same window semantics — extract copies only the requested rows) and
    the shared conformance tests pin that
    (tests/test_readout_and_tde_tpg.py).  Pops are row-exact: a segment
    consumed from the front advances a start offset; fully-consumed
    segments release their slab reference.
    """

    def __init__(self, payload_size: int, capacity: int | None = None):
        self.payload_size = int(payload_size)
        self.capacity = capacity
        self._segs: list[tuple[np.ndarray, np.ndarray]] = []  # (keys, rows)
        self._first_live = 0          # live start offset in _segs[0]
        self._nlive = 0
        self._lock = threading.RLock()
        self.total_inserted = 0
        self.num_keys_clamped = 0

    def _newest_key(self):
        return self._segs[-1][0][-1] if self._segs else None

    def insert(self, keys: np.ndarray, payloads: np.ndarray) -> int:
        n = len(keys)
        if n == 0:
            return 0
        with self._lock:
            if self.capacity is not None:
                room = self.capacity - self._nlive
                if room <= 0:
                    return 0
                if n > room:
                    keys, payloads, n = keys[:room], payloads[:room], room
            raw = np.asarray(keys, dtype=np.uint64)
            clamped = np.maximum.accumulate(raw)
            newest = self._newest_key()
            if newest is not None and clamped[0] < newest:
                clamped = np.maximum(clamped, newest)
            self.num_keys_clamped += int(np.count_nonzero(clamped != raw))
            rows = payloads if payloads.ndim == 2 else \
                payloads.reshape(n, self.payload_size)
            self._segs.append((clamped, rows))
            self._nlive += n
            self.total_inserted += n
            return n

    # -- queries ----------------------------------------------------------
    def occupancy(self) -> int:
        with self._lock:
            return self._nlive

    def oldest_ts(self):
        with self._lock:
            if not self._nlive:
                return None
            return int(self._segs[0][0][self._first_live])

    def newest_ts(self):
        with self._lock:
            return int(self._newest_key()) if self._nlive else None

    def key_at(self, idx: int):
        with self._lock:
            if idx >= self._nlive:
                return None
            idx += self._first_live
            for seg_keys, _ in self._segs:
                if idx < len(seg_keys):
                    return int(seg_keys[idx])
                idx -= len(seg_keys)
            return None

    def _window_pieces(self, start_ts: int, end_ts: int):
        """(segment index, lo, hi) row ranges with start <= key < end,
        clipped to the live region."""
        pieces = []
        # exact saturating coercion — see PayloadRingBuffer._window_bounds
        start_ts = _exact_key(start_ts, np.dtype(np.uint64))
        end_ts = _exact_key(end_ts, np.dtype(np.uint64))
        for i, (seg_keys, _) in enumerate(self._segs):
            lo = int(np.searchsorted(seg_keys, start_ts, side="left"))
            hi = int(np.searchsorted(seg_keys, end_ts, side="left"))
            if i == 0:
                lo, hi = max(lo, self._first_live), max(hi, self._first_live)
            if hi > lo:
                pieces.append((i, lo, hi))
            # segments are globally ordered: once a segment starts at or
            # past end_ts, later ones do too
            if len(seg_keys) and seg_keys[0] >= end_ts:
                break
        return pieces

    def extract_window(self, start_ts: int, end_ts: int) -> np.ndarray:
        """Payload rows with start_ts <= key < end_ts (copied — the only
        copy this buffer ever makes, and only of requested rows)."""
        with self._lock:
            pieces = self._window_pieces(start_ts, end_ts)
            if not pieces:
                return np.zeros((0, self.payload_size), np.uint8)
            return np.concatenate([self._segs[i][1][lo:hi]
                                   for i, lo, hi in pieces])

    def extract_window_keys(self, start_ts: int, end_ts: int) -> np.ndarray:
        with self._lock:
            pieces = self._window_pieces(start_ts, end_ts)
            if not pieces:
                return np.zeros(0, np.uint64)
            return np.concatenate([self._segs[i][0][lo:hi]
                                   for i, lo, hi in pieces])

    # -- cleanup ----------------------------------------------------------
    def _drop_front(self, n: int) -> int:
        """Advance the live start by n rows, releasing slab references."""
        dropped = 0
        while n > 0 and self._segs:
            seg_keys, _ = self._segs[0]
            avail = len(seg_keys) - self._first_live
            take = min(n, avail)
            self._first_live += take
            dropped += take
            n -= take
            if self._first_live == len(seg_keys):
                self._segs.pop(0)
                self._first_live = 0
        self._nlive -= dropped
        return dropped

    def pop_until(self, ts: int) -> int:
        with self._lock:
            total = 0
            ts = _exact_key(ts, np.dtype(np.uint64))
            for seg_keys, _ in list(self._segs):
                lo = int(np.searchsorted(seg_keys, ts, side="left"))
                live_lo = lo - self._first_live
                if live_lo <= 0:
                    break
                total += self._drop_front(live_lo)
                if lo < len(seg_keys):
                    break
            return total

    def pop_n(self, n: int) -> int:
        with self._lock:
            n = min(int(n), self._nlive)
            if n <= 0:
                return 0
            return self._drop_front(n)

    def cleanup_max_ts_diff(self, max_ts_diff: int) -> int:
        with self._lock:
            if not self._nlive:
                return 0
            return self.pop_until(int(self._newest_key())
                                  - int(max_ts_diff))

    def snapshot(self) -> np.ndarray:
        with self._lock:
            if not self._nlive:
                return np.zeros((0, self.payload_size), np.uint8)
            parts = [rows[self._first_live if i == 0 else 0:]
                     for i, (_, rows) in enumerate(self._segs)]
            return np.concatenate(parts)


class ReadoutRequestHandler:
    """Per-link raw-data buffering and request service
    (≈ DefaultRequestHandlerModel over a SkipListLatencyBuffer).

    Storage (``retention``):

    * ``"zerocopy"`` (default) — :class:`SegmentedPayloadBuffer`: insert
      keeps a reference to the caller's batch slab, no memcpy.  Requires
      the producer not to mutate inserted rows (the apps/emulator
      allocate fresh slabs per batch; a NIC hands off filled ring
      slots the same way).
    * ``"ring"`` — :class:`PayloadRingBuffer`: one-memcpy insert into an
      owned arena; for producers that recycle their buffers.
    * ``"record"`` — the general ordered record buffer (python or native
      per ``prefer_native``) for streams NOT time-ordered at arrival.

    The legacy ``ring`` kwarg keeps its original ownership semantics:
    an explicit ``ring=True`` selects the copying ``"ring"`` arena (the
    pre-zerocopy behavior callers may depend on when they recycle their
    frame buffers), ``ring=False`` maps to ``"record"``; only when
    neither ``ring`` nor ``retention`` is given does the handler default
    to ``"zerocopy"``."""

    def __init__(self, adapter: TypeAdapter, capacity: int | None = None,
                 prefer_native: bool = True, ring: bool | None = None,
                 retention: str | None = None):
        self.adapter = adapter
        if retention is None:
            retention = ("zerocopy" if ring is None
                         else "ring" if ring else "record")
        if retention not in ("zerocopy", "ring", "record"):
            raise ValueError(f"unknown retention mode {retention!r}")
        self.retention = retention
        self.ring = retention != "record"   # row-array (not record) storage
        self.record_dtype = payload_record_dtype(adapter.fixed_payload_size)
        if retention == "zerocopy":
            self.buffer = SegmentedPayloadBuffer(adapter.fixed_payload_size,
                                                 capacity)
        elif retention == "ring":
            self.buffer = PayloadRingBuffer(adapter.fixed_payload_size,
                                            capacity)
        else:
            self.buffer = make_latency_buffer(self.record_dtype, capacity,
                                              prefer_native=prefer_native)
        self.metrics = MetricsCollector()

    def insert_payloads(self, payloads: np.ndarray,
                        keys: np.ndarray | None = None) -> int:
        """Store a batch of raw payloads ((N, size) uint8).  ``keys``
        (the per-payload first timestamps) may be passed when the caller
        already decoded the headers (apa_readout's batched preprocess)."""
        n = payloads.shape[0]
        if keys is None:
            keys = self.adapter.get_first_timestamp(payloads)
        keys = np.asarray(keys, dtype=np.uint64).reshape(n)
        if self.ring:
            accepted = self.buffer.insert(keys, payloads)
        else:
            recs = np.zeros(n, dtype=self.record_dtype)
            recs["time_start"] = keys
            recs["payload"] = payloads
            accepted = self.buffer.insert(recs)
        self.metrics.inc("num_payloads_buffered", accepted)
        if accepted < n:
            self.metrics.inc("num_payloads_dropped", n - accepted)
        if self.ring:
            self.metrics.set_max("num_keys_clamped",
                                 self.buffer.num_keys_clamped)
        return accepted

    def request(self, start_ts: int, end_ts: int) -> np.ndarray:
        """Serve a DataRequest window: all payloads whose first timestamp is
        in [start - payload_span, end) — a payload *covering* the window
        start is included, like get_fragment_pieces' window logic."""
        self.metrics.inc("num_requests")
        span = self.adapter.payload_tick_difference
        win = self.buffer.extract_window(max(0, start_ts - span + 1), end_ts)
        return win if self.ring else win["payload"]

    def request_fragment(self, start_ts: int, end_ts: int, *,
                         run_number: int = 0, trigger_number: int = 0,
                         source_id: int = 0, sequence_number: int = 0):
        """Serve a DataRequest as a daqdataformats-style Fragment (payloads
        + FragmentHeader with the requested window)."""
        from ..formats.fragment import build_fragment
        payloads = self.request(start_ts, end_ts)
        return build_fragment(
            payloads, run_number=run_number, trigger_number=trigger_number,
            window_begin=start_ts, window_end=end_ts, source_id=source_id,
            fragment_type=self.adapter.fragment_type,
            sequence_number=sequence_number,
            subsystem=self.adapter.subsystem)

    def cleanup(self, max_ts_diff: Optional[int] = None,
                max_occupancy: Optional[int] = None) -> int:
        dropped = 0
        if max_ts_diff is not None:
            dropped += self.buffer.cleanup_max_ts_diff(max_ts_diff)
        if max_occupancy is not None:
            excess = self.buffer.occupancy() - max_occupancy
            if excess > 0:
                # exact-count trim: no whole-buffer snapshot, safe for
                # max_occupancy=0 and duplicate timestamps
                dropped += self.buffer.pop_n(excess)
        if dropped:
            self.metrics.inc("num_payloads_cleaned", dropped)
        return dropped

    def occupancy(self) -> int:
        return self.buffer.occupancy()
