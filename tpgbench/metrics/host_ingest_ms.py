"""host_ingest_ms: the app's batched preprocess and zero-copy raw
retention, host ms a batch, mean over the window."""

from ._timings import mean_of


def read(run: dict):
    return mean_of(run, "preprocess_ms", "retention_ms")
