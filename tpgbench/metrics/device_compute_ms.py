"""device_compute_ms: device time of every kernel record a batch (the TPG
kernel, compaction, device unpack; copies and memsets excluded), from
the traced segment."""

from ._timings import per_batch_ms


def read(run: dict):
    return per_batch_ms(run, "kernel_s")
