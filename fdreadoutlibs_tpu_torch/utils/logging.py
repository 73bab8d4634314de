"""Tracing / logging (≈ TRACE/ERS TLOG with debug levels).

Copied from ``fdreadoutlibs_tpu/utils/logging.py:1-48``; the code is
unchanged.  Its ``device_trace`` (:51-56) wraps ``jax.profiler``; the
port's, below, is a ``torch.profiler`` capture (CPU and CUDA activities)
that writes a Chrome trace under its directory.

The reference traces via TLOG_DEBUG(TLVL_*) levels; here the same level
taxonomy maps onto the stdlib logger plus a timing context manager for the
wall-clock rate computations the reference does in get_info
(WIBEthFrameProcessor.cpp:249-259).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

log = logging.getLogger("fdreadoutlibs_tpu")

# TRACE level taxonomy (readoutlibs ReadoutLogging.hpp)
TLVL_HOUSEKEEPING = 11
TLVL_TAKE_NOTE = 12
TLVL_BOOKKEEPING = 13
TLVL_WORK_STEPS = 14
TLVL_FRAME_RECEIVED = 15

for _name, _lvl in [("HOUSEKEEPING", TLVL_HOUSEKEEPING),
                    ("TAKE_NOTE", TLVL_TAKE_NOTE),
                    ("BOOKKEEPING", TLVL_BOOKKEEPING),
                    ("WORK_STEPS", TLVL_WORK_STEPS),
                    ("FRAME_RECEIVED", TLVL_FRAME_RECEIVED)]:
    logging.addLevelName(_lvl, f"TLVL_{_name}")


def tlog(level: int, msg: str, *args) -> None:
    """TLOG_DEBUG(level) equivalent."""
    log.log(level, msg, *args)


@contextlib.contextmanager
def timed(name: str, metrics=None, level: int = TLVL_BOOKKEEPING):
    """Wall-clock a block; optionally record into a MetricsCollector."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.inc(f"time_us_{name}", int(dt * 1e6))
        log.log(level, "%s took %.3f ms", name, dt * 1e3)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(dirname: str | None = None):
    """``torch.profiler`` trace around a block, written as a Chrome trace
    to ``dirname/trace.json`` (open with Perfetto or chrome://tracing).
    ``dirname`` defaults to ``fdreadout_trace`` under the temporary
    directory.  CUDA activity is recorded when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dirname = dirname or os.path.join(tempfile.gettempdir(),
                                      "fdreadout_trace")
    os.makedirs(dirname, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(dirname, TRACE_FILE))
