"""The traced segment of a run: a ``torch.profiler`` capture (CPU and
CUDA activity) of a fixed number of steps after the measured window, and
its reduction to device busy time, device time by operation and the
device's idle gaps by what the host was doing.

The capture's arithmetic is the port's ``utils/logging.device_trace``
(CUPTI kept up, ``TEARDOWN_CUPTI=0``), with its retake of a capture that
CUPTI delivered short of its device records: a capture whose kernel
records number fewer than the kernels launched is taken again, up to
three times.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SEGMENT = "tpgbench.traced"
RETAKES = 3


def capture(steps: int, step) -> dict:
    """Run ``step()`` ``steps`` times under the profiler; returns the
    capture's complete events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    for _ in range(RETAKES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SEGMENT):
                for _ in range(steps):
                    step()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f).get("traceEvents", [])
                          if e.get("ph") == "X"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        launched = sum(str(e.get("name", "")).startswith(
            ("cudaLaunch", "cuLaunch")) for e in events)
        if kernels >= launched:
            break
    return {"events": events}


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _label_gaps(busy: list, t0: float, t1: float, host: list) -> dict:
    """Idle seconds between the merged busy intervals, summed by the
    innermost host event under way at each gap's middle (the latest
    started of those still running: host events on a thread nest)."""
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host.sort()
    out = defaultdict(float)
    active, i = [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host Python/NumPy"
        out[label[:64]] += (e - s) * 1e-6
    return out


def reduce(cap: dict, top: int = 10) -> dict:
    """Device busy and window seconds, per-category device seconds, the
    number of kernel records that start inside the segment, the device
    operations that took most time and the longest idle gaps by the
    innermost host event under way at the gap's middle."""
    ev = cap["events"]
    seg = [e for e in ev if e.get("name") == SEGMENT
           and e.get("cat") == "user_annotation"]
    if not seg:
        raise RuntimeError("the trace holds no traced segment")
    t0 = float(seg[0]["ts"])
    t1 = t0 + float(seg[0]["dur"])
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    iv = [(max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]),
                                        t1)) for e in dev]
    busy, merged = _union([(s, e) for s, e in iv if e > s])
    by_name = defaultdict(float)
    by_cat = defaultdict(float)
    for e in dev:
        by_name[str(e["name"])[:64]] += float(e["dur"]) * 1e-6
        by_cat[e["cat"]] += float(e["dur"]) * 1e-6
    h2d = sum(float(e["dur"]) * 1e-6 for e in dev
              if e["cat"] == "gpu_memcpy" and "HtoD" in str(e["name"]))
    by_gap = _label_gaps(merged, t0, t1, [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
        for e in ev if e.get("cat") in HOST_CATS and e.get("name") != SEGMENT])
    return {"busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "kernel_s": by_cat["kernel"], "h2d_s": h2d,
            "kernels": sum(e["cat"] == "kernel" and t0 <= float(e["ts"]) < t1
                           for e in dev),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]}
