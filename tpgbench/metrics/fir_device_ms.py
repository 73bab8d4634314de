"""fir_device_ms: device time between the ProtoWIB processors' CUDA events
around each plane's FIR launch (the kernel, its output memset and state
copy, and any wait for the host's launch), ms an APA-batch (both planes
of every link summed), mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "fir_device_ms")
