"""words_ms: host ms a batch in the app's span ``apa.words``, mean over
the window.  On the time2 feed the codec reads the batch's frames in
place, and the span holds only the view of tick 0 that seeds the first
batch; the packed, fused and words14 feeds copy the frames into a words
page there (``wibeth.frames_bytes_to_u32``)."""

from ._spans import mean_of


def read(run: dict):
    return mean_of(run, "words_ms")
