"""The port's time2 ingest + on-device compaction against the JAX package
on the same host feed (``native.relayout_time2(pad8=False)``): the packed
(max_hits + 1, 6) outputs, trailer included, must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu_torch.formats import wibeth
from fdreadoutlibs_tpu_torch.ops import ingest, tpg
from fdreadoutlibs_tpu_torch.testing import tpg_stream

torch.set_num_threads(1)

L, N, TC, K = 3, 4, 128, 2
T, C = N * 64, L * 64


def make_words(seed):
    """(L, T, 28) packed frame words holding tpg_stream's ADCs."""
    adcs, rmf = tpg_stream(T, C, TC, K, seed)
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), np.uint8)
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[:, l * 64:(l + 1) * 64]
                        .reshape(N, 64, 64).astype(np.uint16))
    words = wibeth.frames_bytes_to_u32(frames.reshape(-1, wibeth.FRAME_SIZE))
    return words.reshape(L, T, 28), adcs, rmf


CASES = [
    (TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120), 2048),
    (TPGConfig.from_raw("AbsRS", threshold=150), 2048),
    (TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150), 2048),
    (TPGConfig.from_raw("AbsRS", threshold=150), 5),   # max_hits < valid
]


@pytest.mark.parametrize("cfg,max_hits", CASES,
                         ids=["Simple", "AbsRS", "StandardRS",
                              "AbsRS-overflow"])
def test_time2_ingest_and_compaction_match_jax(cfg, max_hits):
    words, adcs, rmf = make_words(seed=13)
    feed = native.relayout_time2(words, pad8=False)
    assert feed.shape == (T // 2, -(-C // 128), 128)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    stack = jtpg.pack_state(st, C)
    state = tpg.pack_state(st, C)
    for b in range(2):               # two batches: state carried on device
        js, jn, stack = jingest.process_time2_feed(
            jnp.asarray(feed), stack, cfg, C, tc=TC, k_slots=K, unroll=2,
            interpret=True)
        j_packed = np.asarray(jingest.compact_on_device(
            js, jn, 0, C, max_hits))
        ps, pn, state = ingest.process_time2_feed(
            torch.from_numpy(feed), state, cfg, C, tc=TC, k_slots=K)
        p_packed = ingest.compact_on_device(ps, pn, 0, C, max_hits)
        assert p_packed.dtype == torch.int32
        np.testing.assert_array_equal(p_packed.numpy(), j_packed)
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
    n, dropped = int(j_packed[-1, 0]), int(j_packed[-1, 1])
    assert n > 0 and dropped > 0     # the burst chunk overflows K
    if max_hits < 2048:
        assert n == max_hits
    hits, d = ingest.unpack_compact(p_packed)
    j_hits, j_d = jingest.unpack_compact(j_packed)
    np.testing.assert_array_equal(hits, j_hits)
    assert d == j_d == dropped


def test_compact_tick_offset_and_unpack():
    """tick_offset shifts end ticks in compaction only; unpack_compact
    decodes the trailer."""
    cfg = CASES[1][0]
    words, adcs, rmf = make_words(seed=17)
    feed = torch.from_numpy(native.relayout_time2(words, pad8=False))
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C)
    slots, nclose, _ = ingest.process_time2_feed(feed, state, cfg, C, tc=TC,
                                                 k_slots=8)
    h0, d0 = ingest.unpack_compact(ingest.compact_on_device(
        slots, nclose, 0, C, 2048))
    h1, d1 = ingest.unpack_compact(ingest.compact_on_device(
        slots, nclose, 1000, C, 2048))
    assert len(h0) > 0 and d0 == d1 == 0
    np.testing.assert_array_equal(h1["end_tick"], h0["end_tick"] + 1000)
    with pytest.raises(ValueError):
        ingest.compact_on_device(slots, nclose, 0, C + 1, 2048)
