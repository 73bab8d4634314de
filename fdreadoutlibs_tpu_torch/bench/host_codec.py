"""Host feed codec throughput on the port's native codecs (CPU only).

Counterpart of ``scripts/bench_host_codec.py`` (``bench_one`` :33-40) and
of ``bench.py::bench_host_codecs`` (:352-386): steady state, reused aligned
output buffers (a fresh ~50 MB output page-faults every call), one core,
GB/s of packed input for the time2 and words14 relayouts of 40 WIBEth links,
the time2 relayout read from those links' frames in place (``time2_frames``:
the ADC regions' bytes) and the time2 relayout of 10 WIB2 links (256
channels, 112 words a tick).
An APA's raw WIBEth rate is 8.75 GB/s of packed input.
"""

from __future__ import annotations

import time

import numpy as np

from .. import native


def bench_one(fn, seconds: float) -> float:
    """Seconds per call of ``fn`` over ``seconds`` of calls, after one
    warm-up call (which page-faults the output buffers)."""
    fn()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        fn()
        n += 1
    return (time.perf_counter() - t0) / n


def codec_cases(L: int = 40, T: int = 4096, seed: int = 1) -> list:
    """(name, packed input bytes, fn(FeedBuffer) -> feed) of each codec, on
    random words made from ``seed`` as the JAX bench makes them, and on
    random (L, T/64, 7200) frames."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, size=(L, T, 28), dtype=np.uint32)
    w2_words = rng.integers(0, 2 ** 32, size=(10, T, 112), dtype=np.uint32)
    frames = rng.integers(0, 256, size=(L, T // 64, 7200), dtype=np.uint8)
    return [
        ("time2", words.nbytes, lambda b: native.relayout_time2(
            words, out=b.get(native.time2_feed_shape(L, T)))),
        ("time2_frames", L * T * 28 * 4,
         lambda b: native.relayout_time2_frames(
             frames, out=b.get(native.time2_feed_shape(L, T)))),
        ("words14", words.nbytes, lambda b: native.relayout_words14(
            words, out=b.get(native.words14_feed_shape(L, T)))),
        ("time2_wib2", w2_words.nbytes, lambda b: native.relayout_time2(
            w2_words, ch_per_link=256,
            out=b.get(native.time2_feed_shape(10, T, ch_per_link=256))))]


def bench_host_codecs(seconds: float = 2.0) -> dict:
    """{"host_<codec>_GBps_per_core": GB/s} for each codec; raises when the
    native library does not load (no number is taken on the numpy
    fallback)."""
    if native.load() is None:
        raise RuntimeError("the native host codecs did not build or load")
    out = {}
    for name, nbytes, fn in codec_cases():
        buf = native.FeedBuffer()
        dt = bench_one(lambda: fn(buf), seconds)
        out[f"host_{name}_GBps_per_core"] = round(nbytes / 1e9 / dt, 2)
    return out
