"""Tracing / logging (≈ TRACE/ERS TLOG with debug levels).

The level taxonomy and ``tlog`` follow
``fdreadoutlibs_tpu/utils/logging.py:1-44``.  The timing helper is the
port's own: :func:`span` adds a block's host milliseconds to a row of
stage timings and, while a ``torch.profiler`` capture is recording, opens
a range of the same name on the profiler's clock, the timeline of the
card's CUPTI records.  ``device_trace`` (the JAX package's wraps
``jax.profiler``, :51-56) is a ``torch.profiler`` capture (CPU and CUDA
activities) that writes a Chrome trace under its directory.

The reference traces via TLOG_DEBUG(TLVL_*) levels; here the same level
taxonomy maps onto the stdlib logger.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import tempfile
import time

import torch

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
def span(name: str, row: dict, key: str | None = None):
    """Time a block on the host clock: its milliseconds are added to
    ``row[key]`` (default: the last dotted part of ``name`` and ``_ms``,
    so ``"apa.codec"`` -> ``"codec_ms"``).  While a torch profiler is
    recording, the block is also a ``record_function(name)`` range; with
    none recording it opens no range."""
    key = key or name.rpartition(".")[2] + "_ms"
    rf = (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled() else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with rf:
            yield
    finally:
        row[key] = row.get(key, 0.0) + (time.perf_counter() - t0) * 1e3


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(dirname: str | None = None):
    """``torch.profiler`` trace around a block, written as a Chrome trace
    to ``dirname/trace.json`` (open with Perfetto or chrome://tracing).
    ``dirname`` defaults to ``fdreadout_trace`` under the temporary
    directory.  CUDA activity is recorded when a card is present.

    With a card, CUPTI is kept up between captures (``TEARDOWN_CUPTI=0``
    in the process environment, unless the caller set it): torch tears it
    down after each capture by default, and the next capture's lazy
    re-initialisation loses the device records of its first launches,
    now and then of all of them."""
    from torch.profiler import ProfilerActivity, profile
    dirname = dirname or os.path.join(tempfile.gettempdir(),
                                      "fdreadout_trace")
    os.makedirs(dirname, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(dirname, TRACE_FILE))


def trace_counts(dirname: str) -> tuple:
    """The complete events of a ``device_trace`` capture under ``dirname``,
    counted by category and by name: on a card, the ``kernel`` and
    ``gpu_memcpy`` records beside the runtime calls that asked for them
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``)."""
    with open(os.path.join(dirname, TRACE_FILE)) as f:
        events = [ev for ev in json.load(f).get("traceEvents", [])
                  if ev.get("ph") == "X"]
    return (collections.Counter(ev.get("cat") for ev in events),
            collections.Counter(ev.get("name") for ev in events))


def device_records(dirname: str) -> dict:
    """A ``device_trace`` capture's device records beside the host calls
    that asked for them: kernel records and kernel launches, copy records
    and copy calls.  On a card the pairs are equal when CUPTI delivered
    the whole capture."""
    by_cat, by_name = trace_counts(dirname)
    return {"kernel": by_cat["kernel"],
            "launched": sum(n for name, n in by_name.items()
                            if name.startswith(("cudaLaunch", "cuLaunch"))),
            "gpu_memcpy": by_cat["gpu_memcpy"],
            "copied": by_name["cudaMemcpyAsync"]}
