"""Timestamp-ordered latency buffer.

Port copy of ``fdreadoutlibs_tpu/tp/latency_buffer.py``: identical code apart
from imports; the native C++ buffer is the port's ``native`` copy.

Equivalent of readoutlibs::SkipListLatencyBufferModel (folly
ConcurrentSkipList) as exercised by the reference (SURVEY.md §2.6 item 2):
ordered insertion, head/tail timestamps, windowed extraction
(get_fragment_pieces, TPCTPRequestHandler.cpp:121-133) and front cleanup
(DAPHNEListRequestHandler.cpp:17-59).

Implementation: batches append to a pending list and are merged into one
sorted structured array lazily — batch-oriented insertion is the TPU-native
arrival pattern, so amortized cost is O(n log n) per consolidation instead
of per-element skip-list hops.  Thread-safe.
"""

from __future__ import annotations

import threading

import numpy as np


def _exact_key(v, key_dtype: np.dtype):
    """Coerce a window/pop boundary to the key column's dtype EXACTLY
    (saturating at the dtype's range).

    np.searchsorted(uint64_keys, python_int) promotes both sides to
    float64, which is lossy above 2**53: a boundary near 2**63 rounded
    onto its neighbors and extract_window returned wrong (even empty)
    windows for top-bit-set corrupt-header timestamps — found by the
    python-vs-native differential in scripts/fuzz_tp_path.py."""
    info = np.iinfo(key_dtype)
    return key_dtype.type(min(max(int(v), info.min), info.max))


class LatencyBuffer:
    """Ordered store of records with a ``time_start``-like key field."""

    def __init__(self, key: str = "time_start", capacity: int | None = None,
                 dtype=None):
        self.key = key
        self.capacity = capacity
        self.dtype = dtype          # record dtype; learned from first insert
        self._sorted: np.ndarray | None = None
        self._keys: np.ndarray | None = None   # contiguous key column
        self._pending: list[np.ndarray] = []
        self._lock = threading.RLock()
        self.total_inserted = 0

    # -- insertion -------------------------------------------------------
    def insert(self, batch: np.ndarray) -> int:
        """Insert a batch; returns number accepted (capacity-limited)."""
        if len(batch) == 0:
            return 0
        with self._lock:
            n = len(batch)
            if self.capacity is not None:
                room = self.capacity - self.occupancy()
                if room <= 0:
                    return 0
                batch = batch[:room]
                n = len(batch)
            batch = np.asarray(batch)
            if self.dtype is None:
                self.dtype = batch.dtype
            self._pending.append(batch.copy())
            self.total_inserted += n
            return n

    def _consolidate(self) -> np.ndarray:
        """Merge pending batches into the sorted store.

        Two-way merge, O(n + k log k): re-sorting the whole buffer per
        consolidation made the insert->window cycle O(n log n) per batch
        and capped the TP request-handler loop at ~65k TPs/s at APA
        occupancies (bench_tp_path).  side="right" keeps equal-key
        stability identical to a stable argsort of [sorted, pending].
        ``_keys`` mirrors the key field contiguously: searchsorted on a
        structured-field view buffers the whole strided column per query
        (another O(n)-per-call trap measured in bench_tp_path).
        Min/max/occupancy queries deliberately do NOT consolidate (they
        scan the pending maxima instead) so per-batch bookkeeping stays
        O(pending) and the merge amortizes over window extractions."""
        if self._pending:
            pend = (np.concatenate(self._pending)
                    if len(self._pending) > 1 else self._pending[0])
            pkeys = np.ascontiguousarray(pend[self.key])
            order = np.argsort(pkeys, kind="stable")
            pend, pkeys = pend[order], pkeys[order]
            if self._sorted is None or not len(self._sorted):
                self._sorted, self._keys = pend, pkeys
            else:
                base, bkeys = self._sorted, self._keys
                pos = np.searchsorted(bkeys, pkeys, side="right")
                out = np.empty(len(base) + len(pend), dtype=base.dtype)
                kout = np.empty(len(out), dtype=bkeys.dtype)
                idx = pos + np.arange(len(pend))
                mask = np.ones(len(out), dtype=bool)
                mask[idx] = False
                out[mask], kout[mask] = base, bkeys
                out[idx], kout[idx] = pend, pkeys
                self._sorted, self._keys = out, kout
            self._pending = []
        if self._sorted is None:
            # empty buffer: a zero-length array of the RECORD dtype (the
            # object-dtype sentinel used here previously broke field access
            # and concatenation for callers that didn't length-check first)
            from ..formats.trigprim import TP_DTYPE
            self._sorted = np.zeros(0, dtype=self.dtype or TP_DTYPE)
            self._keys = np.ascontiguousarray(self._sorted[self.key])
        return self._sorted

    # -- queries ---------------------------------------------------------
    def occupancy(self) -> int:
        with self._lock:
            n = len(self._sorted) if self._sorted is not None else 0
            return n + sum(len(p) for p in self._pending)

    def oldest_ts(self):
        with self._lock:
            vals = []
            if self._sorted is not None and len(self._sorted):
                vals.append(int(self._keys[0]))
            vals += [int(p[self.key].min()) for p in self._pending if len(p)]
            return min(vals) if vals else None

    def newest_ts(self):
        with self._lock:
            vals = []
            if self._sorted is not None and len(self._sorted):
                vals.append(int(self._keys[-1]))
            vals += [int(p[self.key].max()) for p in self._pending if len(p)]
            return max(vals) if vals else None

    def extract_window(self, start_ts: int, end_ts: int) -> np.ndarray:
        """All records with start_ts <= key < end_ts (kept in the buffer;
        the request path reads without consuming, like get_fragment_pieces)."""
        with self._lock:
            arr = self._consolidate()
            if not len(arr):
                return arr
            lo = np.searchsorted(self._keys,
                                 _exact_key(start_ts, self._keys.dtype),
                                 side="left")
            hi = np.searchsorted(self._keys,
                                 _exact_key(end_ts, self._keys.dtype),
                                 side="left")
            return arr[lo:hi].copy()

    def key_at(self, idx: int):
        """Key of the idx-th oldest record (None if out of range) — the
        cheap query the occupancy-trim path uses instead of snapshot()."""
        with self._lock:
            arr = self._consolidate()
            if idx >= len(arr):
                return None
            return int(self._keys[idx])

    # -- cleanup ---------------------------------------------------------
    def pop_until(self, ts: int) -> int:
        """Drop records with key < ts; returns number dropped."""
        with self._lock:
            arr = self._consolidate()
            lo = np.searchsorted(self._keys,
                                 _exact_key(ts, self._keys.dtype),
                                 side="left") if len(arr) else 0
            # copy the tail: a view would pin the whole pre-pop allocation
            # alive until the next consolidation (large payload buffers)
            if lo:
                self._sorted = arr[lo:].copy()
                self._keys = self._keys[lo:].copy()
            return int(lo)

    def pop_n(self, n: int) -> int:
        """Drop the n oldest records (exact count, duplicate-key safe)."""
        with self._lock:
            arr = self._consolidate()
            n = min(int(n), len(arr))
            if n:
                self._sorted = arr[n:].copy()
                self._keys = self._keys[n:].copy()
            return n

    def cleanup_max_ts_diff(self, max_ts_diff: int) -> int:
        """DAPHNEListRequestHandler-style cleanup: pop the oldest until
        newest - oldest <= max_ts_diff (cpp:37-50)."""
        with self._lock:
            newest = self.newest_ts()
            if newest is None:
                return 0
            cutoff = int(newest) - int(max_ts_diff)
            return self.pop_until(cutoff)

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._consolidate().copy()


class NativeLatencyBufferAdapter:
    """Same interface as :class:`LatencyBuffer`, backed by the C++ ordered
    buffer (fdreadoutlibs_tpu_torch/native/latency_buffer.cpp)."""

    def __init__(self, dtype, capacity: int | None = None, key: str = "time_start"):
        from .. import native
        self.key = key
        dtype = np.dtype(dtype)
        # the native buffer keys on the first 8 bytes of each record —
        # reject key fields it cannot honor rather than silently ordering
        # by whatever sits at offset 0
        if dtype.names is None or dtype.names[0] != key or \
                dtype[key].itemsize != 8:
            raise ValueError(
                f"native buffer requires the key field {key!r} to be the "
                f"first 8 bytes of the record dtype; got {dtype}")
        self._buf = native.NativeLatencyBuffer(dtype, capacity or 0)
        self.total_inserted = 0

    def insert(self, batch: np.ndarray) -> int:
        n = self._buf.insert(batch)
        self.total_inserted += n
        return n

    def occupancy(self) -> int:
        return self._buf.occupancy()

    def oldest_ts(self):
        return self._buf.oldest_ts()

    def newest_ts(self):
        return self._buf.newest_ts()

    _U64 = np.dtype(np.uint64)

    def extract_window(self, start_ts: int, end_ts: int) -> np.ndarray:
        # saturate out-of-range boundaries exactly like the python
        # LatencyBuffer: bare int() through ctypes c_uint64 WRAPS
        # (-5 -> 2**64-5, 1<<64 -> 0), silently inverting the window
        return self._buf.extract_window(int(_exact_key(start_ts, self._U64)),
                                        int(_exact_key(end_ts, self._U64)))

    def pop_until(self, ts: int) -> int:
        return self._buf.pop_until(int(_exact_key(ts, self._U64)))

    def pop_n(self, n: int) -> int:
        return self._buf.pop_n(int(n))

    def key_at(self, idx: int):
        return self._buf.key_at(int(idx))

    def cleanup_max_ts_diff(self, max_ts_diff: int) -> int:
        return self._buf.cleanup_max_ts_diff(int(max_ts_diff))

    def snapshot(self) -> np.ndarray:
        # full ordered copy — NOT extract_window(lo, big): the half-open
        # window bound cannot include key UINT64_MAX, and a 1<<63 bound
        # silently dropped top-bit-set (corrupt-header) timestamps that
        # the python buffer retains (found by scripts/fuzz_tp_path.py)
        return self._buf.extract_all()


def make_latency_buffer(dtype=None, capacity: int | None = None,
                        prefer_native: bool = True):
    """Factory: native C++ ordered buffer when available (and a dtype is
    given), else the pure-Python sorted buffer."""
    if prefer_native and dtype is not None:
        try:
            from .. import native
            if native.available():
                return NativeLatencyBufferAdapter(dtype, capacity)
        except Exception:
            pass
    return LatencyBuffer(capacity=capacity, dtype=dtype)
