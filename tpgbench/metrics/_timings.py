"""Shared arithmetic of the readers of the app's per-batch host timings
(``APAReadoutApp.batch_timings``: host clock, the compact-hit fetch is
the sync)."""

from __future__ import annotations

import numpy as np


def mean_of(run: dict, *keys: str):
    rows = run.get("batch_timings")
    if not rows:
        return None
    return float(np.mean([sum(r[k] for k in keys) for r in rows]))


def per_batch_ms(run: dict, key: str):
    """A traced quantity (seconds) in milliseconds per traced batch."""
    tr = run.get("trace")
    if not tr or not tr["batches"] or not tr["busy_s"]:
        return None
    return tr[key] * 1e3 / tr["batches"]
