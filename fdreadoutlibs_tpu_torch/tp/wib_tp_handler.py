"""Legacy per-link TP handler (ProtoWIB path).

Port copy of ``fdreadoutlibs_tpu/tp/wib_tp_handler.py:1-92``: the same code
apart from imports.

Port of WIBTPHandler (include/fdreadoutlibs/wib/WIBTPHandler.hpp): a
time-ordered TP buffer that drops TPs older than ``tp_timeout`` on insert
(:meth:`add_tp`, hpp:49-57) and drains fixed, ``tpset_window_size``-aligned
TPSets once the oldest TP is safely in the past
(:meth:`try_sending_tpsets`, hpp:59-92).

The reference keeps a priority queue and pushes one TP at a time; here the
store is the batch-merged ordered buffer (:class:`~.latency_buffer
.LatencyBuffer`) because TPs arrive as vectorized kernel batches — per-TP
heap pushes capped this path at ~0.2 M TPs/s on one core (bench_tp_path)
while the merged store inserts at several M TPs/s.  Equal-timestamp TPs
keep arrival order (stable merge == the reference's (ts, seq) tiebreak).
``tp_sink`` receives each drained window as ONE numpy batch (transport
moves batches, stream/transport.py docstring), not per-TP sends.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..formats.trigprim import TP_DTYPE, TPSet, TPSetType
from .latency_buffer import LatencyBuffer


class WIBTPHandler:

    def __init__(self, tp_sink=None, tpset_sink=None, tp_timeout: int = 10000,
                 tpset_window_size: int = 6400, source_id: int = 0):
        self.tp_sink = tp_sink
        self.tpset_sink = tpset_sink
        self.tp_timeout = tp_timeout
        self.tpset_window_size = tpset_window_size
        self.source_id = source_id
        self.run_number = 0
        self._buffer = LatencyBuffer(key="time_start", dtype=TP_DTYPE)
        self.next_tpset_seqno = 0
        self.sent_tps = 0
        self.sent_tpsets = 0

    def set_run_number(self, run_number: int) -> None:
        self.run_number = run_number

    def add_tp(self, tp: np.ndarray, current_time: int) -> bool:
        """Accept unless the TP is older than tp_timeout (hpp:49-57)."""
        return self.add_tps(np.atleast_1d(tp), current_time) == 1

    def add_tps(self, tps: np.ndarray, current_time: int) -> int:
        """Batch insert; returns the number accepted."""
        if len(tps) == 0:
            return 0
        keep = tps["time_start"].astype(np.int64) + self.tp_timeout \
            > current_time
        kept = tps[keep] if not keep.all() else tps
        if len(kept):
            self._buffer.insert(kept)
        return int(len(kept))

    def try_sending_tpsets(self, current_time: int) -> Optional[TPSet]:
        """Drain one aligned window when safely closed (hpp:59-92)."""
        if self._buffer.occupancy() == 0:
            return None
        top_ts = self._buffer.oldest_ts()
        if top_ts + self.tpset_window_size + self.tp_timeout >= current_time:
            return None
        start = (top_ts // self.tpset_window_size) * self.tpset_window_size
        end = start + self.tpset_window_size
        objs = self._buffer.extract_window(0, end)
        self._buffer.pop_until(end)
        if len(objs) and self.tp_sink is not None:
            self.tp_sink.try_send(objs)
        self.sent_tps += len(objs)
        tpset = TPSet(run_number=self.run_number, type=TPSetType.kPayload,
                      origin=self.source_id, start_time=start, end_time=end,
                      seqno=self.next_tpset_seqno, objects=objs)
        self.next_tpset_seqno += 1
        if self.tpset_sink is not None:
            self.tpset_sink.try_send(tpset)
        self.sent_tpsets += 1
        return tpset

    def reset(self) -> None:
        self._buffer = LatencyBuffer(key="time_start", dtype=TP_DTYPE)
        self.next_tpset_seqno = 0
        self.sent_tps = 0
        self.sent_tpsets = 0

    def __len__(self) -> int:
        return self._buffer.occupancy()
