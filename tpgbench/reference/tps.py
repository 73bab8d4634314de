"""Hit -> TP assembly and TPSet windowing in the plain reference.

Assembly (``WIBEthFrameProcessor.cpp:479-572``): a hit becomes a TP only
when its charge, read as uint16, is nonzero; the TP starts at the
batch's frame timestamp plus 32 clocks per tick before the close by the
time over threshold, peaks ``peak_time`` ticks later, carries the
offline channel, the uint16 charge as its integral, the peak sample,
the detector id of the link's frames, type TPC (1), algorithm
AbsRunningSum (2) and version 1.  A TP longer than the processor's
``tp_timeout`` clocks is suppressed.

Windowing (``TPCTPRequestHandler.cpp:100-193``, with heartbeats on the
stream clock): after each batch the handler inserts the batch's TPs,
except those that start before the cutoff; advances its stream clock to
the batch's last frame timestamp; and, when the newest of that clock and
the buffered TPs' starts lies more than ``min_latency`` clocks past the
window start, emits the TPs starting in [start, newest - min_latency) as
one TPSet: a payload set bounded by its first and last TP start, or a
heartbeat bounded by the window.  The set's end becomes the cutoff and
the window's end the next start.
"""

from __future__ import annotations

import numpy as np

TP_FIELDS = ("time_start", "time_peak", "time_over_threshold", "channel",
             "adc_integral", "adc_peak", "detid", "type", "algorithm",
             "version", "flag")
TYPE_TPC, ALGO_ABS_RS, VERSION = 1, 2, 1
PAYLOAD, HEARTBEAT = 1, 2


def assemble(hits: dict, t_base: np.ndarray, offline: np.ndarray,
             det_id: int, tp_timeout: int, clocks_per_tick: int = 32):
    """Canonical hits of one batch (``channel`` on the APA's channel axis,
    ``end_tick`` batch-local) -> dict of TP fields (int64 arrays)."""
    charge = hits["charge"] & 0xFFFF
    keep = charge != 0
    h = {k: v[keep] for k, v in hits.items()}
    charge = charge[keep]
    start = t_base[h["channel"] // 64] + clocks_per_tick * (
        h["end_tick"] - h["tover"])
    n = len(start)
    tps = {"time_start": start,
           "time_peak": start + clocks_per_tick * h["peak_time"],
           "time_over_threshold": clocks_per_tick * h["tover"],
           "channel": offline[h["channel"]],
           "adc_integral": charge,
           "adc_peak": h["peak_adc"] & 0xFFFFFFFF,
           "detid": np.full(n, det_id, dtype=np.int64),
           "type": np.full(n, TYPE_TPC, dtype=np.int64),
           "algorithm": np.full(n, ALGO_ABS_RS, dtype=np.int64),
           "version": np.full(n, VERSION, dtype=np.int64),
           "flag": np.zeros(n, dtype=np.int64)}
    short = tps["time_over_threshold"] <= tp_timeout
    return {k: v[short].astype(np.int64) for k, v in tps.items()}


def concat(parts: list) -> dict:
    return {k: np.concatenate([p[k] for p in parts]) for k in TP_FIELDS}


def empty() -> dict:
    return {k: np.zeros(0, dtype=np.int64) for k in TP_FIELDS}


class Windowing:
    """The handler's windowing state: buffered TPs, window start, cutoff,
    stream clock and the next sequence number."""

    def __init__(self, min_latency: int, *, start=None, cutoff: int = 0,
                 seqno: int = 0, buffered=None, stream=None):
        self.min_latency = min_latency
        self.start = start
        self.cutoff = cutoff
        self.seqno = seqno
        self.buffer = buffered if buffered is not None else empty()
        self.stream = stream
        self.first_stream = stream

    def finish_batch(self, tps: dict, stream_ts: int):
        """Insert one batch's TPs and run one emission; returns the TPSet
        (a dict) or None."""
        fresh = tps["time_start"] >= self.cutoff
        self.buffer = concat([self.buffer,
                              {k: v[fresh] for k, v in tps.items()}])
        if self.stream is None or stream_ts > self.stream:
            self.stream = stream_ts
        if self.first_stream is None:
            self.first_stream = stream_ts
        starts = self.buffer["time_start"]
        newest = self.stream if not len(starts) else max(self.stream,
                                                         int(starts.max()))
        if self.start is None:
            self.start = int(starts.min()) if len(starts) \
                else self.first_stream
        if newest - self.start <= self.min_latency:
            return None
        end = newest - self.min_latency
        inside = (starts >= self.start) & (starts < end)
        objs = {k: v[inside] for k, v in self.buffer.items()}
        order = np.lexsort(tuple(objs[k] for k in reversed(TP_FIELDS)))
        objs = {k: v[order] for k, v in objs.items()}
        n = len(objs["time_start"])
        tpset = {"seqno": self.seqno,
                 "type": PAYLOAD if n else HEARTBEAT,
                 "start_time": int(objs["time_start"][0]) if n
                 else self.start,
                 "end_time": int(objs["time_start"][-1]) if n else end,
                 "objects": objs}
        self.seqno += 1
        self.cutoff = tpset["end_time"]
        self.start = end
        return tpset


def window_end(tps: dict, stream_ts: int, min_latency: int) -> int:
    """Where a window closed after a batch whose TPs are ``tps`` (the
    newest of all buffered starts when every earlier batch's TPs start
    before this batch's stream clock)."""
    starts = tps["time_start"]
    newest = max(stream_ts, int(starts.max())) if len(starts) else stream_ts
    return newest - min_latency
