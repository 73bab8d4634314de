"""compact_device_ms: device time between the app's CUDA events around
the compaction's launches (its gaps between them included), ms a batch,
mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "compact_device_ms")
