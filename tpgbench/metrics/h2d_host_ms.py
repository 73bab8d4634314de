"""h2d_host_ms: the host's wait in the app's pageable feed copy to the
card (span ``apa.h2d``), host ms a batch, mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "h2d_host_ms")
