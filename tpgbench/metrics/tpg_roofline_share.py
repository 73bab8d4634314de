"""tpg_roofline_share: the least time a batch's TPG could take at the
card's published HBM rate, as a share of its traced kernel time
(``device_compute_ms``).  The least bytes are the system module's count
for the configuration's frontend (``least_bytes``), over the traced
segment's hits a batch."""

from .. import roofline
from ._timings import per_batch_ms


def read(run: dict):
    ms = per_batch_ms(run, "kernel_s")
    tr = run.get("trace")
    if not ms or "least_bytes" not in tr:
        return None
    least = tr["least_bytes"] / roofline.PEAK_HBM_BYTES_S
    return 100.0 * least * 1e3 / ms
