"""tpg_roofline_share: the least time a batch's TPG could take at the
card's published HBM rate (``roofline.least_bytes``), as a share of its
traced kernel time (``device_compute_ms``)."""

from .. import roofline
from ._timings import per_batch_ms


def read(run: dict):
    ms = per_batch_ms(run, "kernel_s")
    if not ms:
        return None
    cfg, tr = run["config"], run["trace"]
    channels = cfg["links"] * 64
    ticks = run["traffic"]["frames_per_batch"] * 64
    least = roofline.least_seconds(channels, ticks,
                                   tr["hits"] / tr["batches"])
    return 100.0 * least * 1e3 / ms
