"""tpg_device_ms: device time between the app's CUDA events around the
TPG launch (the kernel, its output memset and state copy, and any wait
for the host's launch), ms a batch, mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "tpg_device_ms")
