"""proc_ms_p95: 95th percentile over the window's batches of the app's
host time from a batch's preprocess to its TPSet emission."""

import numpy as np


def read(run: dict):
    rows = run.get("batch_timings")
    if not rows:
        return None
    return float(np.percentile([r["total_ms"] for r in rows], 95))
