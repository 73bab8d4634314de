"""The time2 relayout straight from WIBEth frames
(``native.relayout_time2_frames``) against the JAX package's relayout of
the frames' copied words (its ``native.relayout_time2`` on its
``wibeth.frames_bytes_to_u32``), which shares no code with the port's
codec, bit for bit: dense batches, batches sliced out of a larger buffer (link
and frame strides that are not dense), one and several codec threads,
with and without the lane padding, and the numpy fallback.  Inputs it
cannot read in place are refused."""

import numpy as np
import pytest

from fdreadoutlibs_tpu import native as jax_native
from fdreadoutlibs_tpu.formats import wibeth as jax_wibeth
from fdreadoutlibs_tpu_torch import native


def frames_of(L, N, seed, sliced):
    """(L, N, 7200) random frames; ``sliced`` cuts them out of a larger
    buffer, so neither the link nor the frame axis is dense."""
    rng = np.random.default_rng(seed)
    if not sliced:
        return rng.integers(0, 256, size=(L, N, 7200), dtype=np.uint8)
    big = rng.integers(0, 256, size=(L + 2, 2 * N + 1, 7200),
                       dtype=np.uint8)
    return big[1:L + 1, 1::2]


def words_feed(frames, nthreads, pad8):
    L, N, _ = frames.shape
    words = jax_wibeth.frames_bytes_to_u32(frames).reshape(L, 64 * N, 28)
    return jax_native.relayout_time2(words, nthreads=nthreads, pad8=pad8)


CASES = [(L, N, nthreads, pad8, False)
         for L in (1, 3, 40) for N in (1, 2, 5)
         for nthreads in (1, 3) for pad8 in (True, False)]
CASES += [(L, N, nthreads, pad8, True)
          for L, N in ((3, 2), (40, 5))
          for nthreads in (1, 3) for pad8 in (True, False)]


@pytest.mark.parametrize("L,N,nthreads,pad8,sliced", CASES)
def test_frames_relayout_matches_the_words_relayout(L, N, nthreads, pad8,
                                                    sliced):
    assert native.available() and jax_native.available()
    frames = frames_of(L, N, seed=100 * L + N, sliced=sliced)
    assert frames.flags.c_contiguous != sliced
    want = words_feed(frames, nthreads, pad8)
    got = native.relayout_time2_frames(frames, nthreads=nthreads, pad8=pad8)
    assert got.shape == native.time2_feed_shape(L, 64 * N, pad8=pad8)
    np.testing.assert_array_equal(got, want)
    # into a caller's reused page
    buf = native.FeedBuffer()
    out = buf.get(got.shape)
    assert native.relayout_time2_frames(frames, out=out, nthreads=nthreads,
                                        pad8=pad8) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("sliced", [False, True])
def test_frames_relayout_numpy_fallback(monkeypatch, sliced):
    frames = frames_of(3, 2, seed=7, sliced=sliced)
    want = native.relayout_time2_frames(frames, pad8=False)
    monkeypatch.setattr(native, "load", lambda: None)
    got = native.relayout_time2_frames(frames, pad8=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, words_feed(frames, 1, False))


BAD = {
    "int8": np.zeros((2, 2, 7200), dtype=np.int8),
    "uint32": np.zeros((2, 2, 1800), dtype=np.uint32),
    "last_axis_strided": np.zeros((2, 2, 14400), dtype=np.uint8)[..., ::2],
    "frame_size": np.zeros((2, 2, 7168), dtype=np.uint8),
    "two_axes": np.zeros((4, 7200), dtype=np.uint8),
    "list": [[[0] * 7200]],
}


@pytest.mark.parametrize("case", list(BAD))
def test_frames_relayout_refuses_what_it_cannot_read_in_place(case):
    with pytest.raises(ValueError, match="7200"):
        native.relayout_time2_frames(BAD[case])
