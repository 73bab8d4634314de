"""Shared arithmetic of the readers of the app's stage spans: the
``APAReadoutApp.batch_timings`` rows that ``utils.logging.span`` builds
(host clock), with the CUDA-event device times on a card.  A reader
returns None where the rows lack one of its keys, as a program without
that span gives them."""

from __future__ import annotations

import numpy as np

# the step's named host spans, each one row key
HOST_SPANS = ("preprocess_ms", "retention_ms", "words_ms", "codec_ms",
              "h2d_host_ms", "tpg_launch_ms", "compact_launch_ms",
              "fetch_ms", "assembly_ms", "handler_ms")


def rows_with(run: dict, *keys: str):
    """The window's rows, or None where any lacks one of ``keys``."""
    rows = run.get("batch_timings")
    if not rows or any(k not in r for r in rows for k in keys):
        return None
    return rows


def mean_of(run: dict, *keys: str):
    """Mean over the window's rows of the sum of ``keys``."""
    rows = rows_with(run, *keys)
    if rows is None:
        return None
    return float(np.mean([sum(r[k] for k in keys) for r in rows]))
