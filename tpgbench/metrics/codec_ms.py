"""codec_ms: the app's host feed codec (time2 relayout), host ms a batch,
mean over the window."""

from ._timings import mean_of


def read(run: dict):
    return mean_of(run, "codec_ms")
