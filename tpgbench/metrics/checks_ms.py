"""checks_ms: the ProtoWIB processors' timestamp and WIB error checks
(span ``protowib.checks``), host ms an APA-batch (the links' rows
summed), mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "checks_ms")
