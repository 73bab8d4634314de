"""h2d_ms: device time of host-to-device copies a batch, from the traced
segment's copy records."""

from ._timings import per_batch_ms


def read(run: dict):
    return per_batch_ms(run, "h2d_s")
