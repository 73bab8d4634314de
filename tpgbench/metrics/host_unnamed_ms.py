"""host_unnamed_ms: the host time of a batch's step that no span names,
``step_ms`` less the row's named host spans, ms a batch, mean over the
window: how far the spans fall short of covering the step."""

import numpy as np

from ._spans import HOST_SPANS, rows_with


def read(run: dict):
    rows = rows_with(run, "step_ms", *HOST_SPANS)
    if rows is None:
        return None
    return float(np.mean([r["step_ms"] - sum(r[k] for k in HOST_SPANS)
                          for r in rows]))
