"""fetch_ms: the app's one card-to-host sync, the compact hits' copy and
their decode (span ``apa.fetch``), host ms a batch, mean over the
window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "fetch_ms")
