"""Hit -> TP assembly of the WIB frontend and the legacy WIB TP handler's
TPSets, in the plain reference.

Assembly (upstream ``WIBFrameProcessor.hpp:586-676``): a hit becomes a TP
only when its charge, read as uint16, is nonzero.  With the batch's first
frame timestamp ``ts0`` and 25 clocks a tick, the TP starts at ts0 + 25
(end tick - time over threshold), ends at ts0 + 25 end tick and peaks at
the midpoint (rounded down); it carries the time over threshold in
clocks, the register position's offline channel, the uint16 charge as its
integral and a twentieth of it (rounded down) as its peak, the link as its
detector id, type TPC (1), algorithm SimpleThreshold (1, as upstream
labels the WIB FIR output), version 1 and flag 0.

The handler (upstream ``WIBTPHandler.hpp:49-92``, called once a
superchunk, ``WIBFrameProcessor.hpp:500-526``): a TP is judged at the end
of the superchunk (12 ticks, 300 clocks) in which its hit closed, that is
the superchunk that holds its end tick (its first frame's timestamp plus
300 clocks, the time the readout gives a call of one superchunk); it is suppressed unless it starts
less than ``timeout`` clocks before that time, so only a TP longer than
the timeout is suppressed.  The rest are buffered.  Then, at the batch's
``now`` = ts0 + 25 x its frames, while the buffer holds TPs and the oldest
start plus ``window`` plus ``timeout`` lies before ``now``, one TPSet is
sent: the aligned window [start, start + window) that holds the oldest
start, with every buffered TP that starts before its end, which leave the
buffer.  A set is a payload (type 1) of the handler's origin, numbered
from the handler's next sequence number.  Sending once at the batch's end
sends what one send a superchunk sends by then: a TP that would still
join a window already sent starts before that window's end, so more than
``timeout`` clocks before its own superchunk's end, and is suppressed.
"""

from __future__ import annotations

import torch

TP_FIELDS = ("time_start", "time_peak", "time_over_threshold", "channel",
             "adc_integral", "adc_peak", "detid", "type", "algorithm",
             "version", "flag")
TYPE_TPC, ALGORITHM_SIMPLE_THRESHOLD, VERSION = 1, 1, 1
PAYLOAD = 1
CLOCKS_PER_TICK = 25
SUPERCHUNK_CLOCKS = 12 * CLOCKS_PER_TICK


def empty() -> dict:
    return {f: torch.zeros(0, dtype=torch.int64) for f in TP_FIELDS}


def concat(parts) -> dict:
    return {f: torch.cat([p[f] for p in parts]) for f in TP_FIELDS}


def judged_at(tps: dict, ts0: int) -> torch.Tensor:
    """Each TP's time at the handler: the end of the superchunk its hit
    closed in, from the batch's first frame timestamp ``ts0``."""
    end = tps["time_start"] + tps["time_over_threshold"]
    return ts0 + SUPERCHUNK_CLOCKS * (
        torch.div(end - ts0, SUPERCHUNK_CLOCKS, rounding_mode="floor") + 1)


def assemble(hits: dict, ts0: int, offline: torch.Tensor,
             detid: int) -> dict:
    """One plane's hits of one batch (``channel`` its register positions,
    ``end_tick`` batch-local) -> TP fields as int64 tensors."""
    charge = hits["charge"].to(torch.int64) & 0xFFFF
    keep = charge != 0
    charge = charge[keep]
    end = hits["end_tick"][keep].to(torch.int64)
    tover = hits["tover"][keep].to(torch.int64)
    begin = ts0 + CLOCKS_PER_TICK * (end - tover)
    finish = ts0 + CLOCKS_PER_TICK * end
    n = len(charge)

    def full(v):
        return torch.full((n,), v, dtype=torch.int64)
    return {"time_start": begin,
            "time_peak": torch.div(begin + finish, 2, rounding_mode="floor"),
            "time_over_threshold": CLOCKS_PER_TICK * tover,
            "channel": offline[hits["channel"][keep]].to(torch.int64),
            "adc_integral": charge,
            "adc_peak": torch.div(charge, 20, rounding_mode="floor"),
            "detid": full(detid), "type": full(TYPE_TPC),
            "algorithm": full(ALGORITHM_SIMPLE_THRESHOLD),
            "version": full(VERSION), "flag": full(0)}


class Handler:
    """One link's handler: its buffered TPs and next sequence number."""

    def __init__(self, timeout: int, window: int, origin: int, *,
                 seqno: int = 0, buffered: dict | None = None):
        self.timeout, self.window, self.origin = timeout, window, origin
        self.seqno = seqno
        self.buffer = empty() if buffered is None else buffered

    def insert(self, tps: dict, now) -> int:
        """Buffer the TPs that are not too old at ``now`` (a time, or one a
        TP); returns the suppressed count."""
        keep = tps["time_start"] + self.timeout > now
        self.buffer = concat([self.buffer,
                              {f: v[keep] for f, v in tps.items()}])
        return int((~keep).sum())

    def send(self, now: int) -> list[dict]:
        """Every TPSet the handler sends at ``now``."""
        out = []
        while len(self.buffer["time_start"]):
            oldest = int(self.buffer["time_start"].min())
            if oldest + self.window + self.timeout >= now:
                break
            start = oldest // self.window * self.window
            end = start + self.window
            inside = self.buffer["time_start"] < end
            out.append({"seqno": self.seqno, "type": PAYLOAD,
                        "origin": self.origin, "run_number": 0,
                        "start_time": start, "end_time": end,
                        "objects": {f: v[inside]
                                    for f, v in self.buffer.items()}})
            self.buffer = {f: v[~inside] for f, v in self.buffer.items()}
            self.seqno += 1
        return out
