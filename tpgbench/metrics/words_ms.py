"""words_ms: the app's host words copy (``wibeth.frames_bytes_to_u32``,
span ``apa.words``), host ms a batch, mean over the window."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "words_ms")
