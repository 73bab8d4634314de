"""tp_tail_ms: the app's TP assembly and TP handler (latency buffer, TPSet
windowing, cleanup), host ms a batch, mean over the window."""

from ._timings import mean_of


def read(run: dict):
    return mean_of(run, "assembly_ms", "handler_ms")
