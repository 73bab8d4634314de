"""launch_ms: the host time of the TPG kernel's launch (its knobs too,
span ``apa.tpg``) and of the compaction's launches (span
``apa.compact``), ms a batch, mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "tpg_launch_ms", "compact_launch_ms")
