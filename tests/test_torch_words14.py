"""The port's packed-word ingest (K4's plain version on the CPU) against
the JAX package's fused kernels in Pallas interpret mode and the numpy
oracle: ``process_packed_frames_fused`` (frame words) and
``process_words14_feed`` (host words14 relayout).  The JAX side keeps state
and slots in the words14 lane positions, the port in canonical channel
order; hits, dropped counts, nclose per channel and the carried state must
be equal (tolerance 0: integer pipeline)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.reference import run_reference
from fdreadoutlibs_tpu_torch.formats import wibeth
from fdreadoutlibs_tpu_torch.ops import ingest, tpg
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             tpg_stream)

torch.set_num_threads(1)

T, TC, K = 256, 64, 2
_FIR = TPGConfig.from_raw("FIR", threshold=5)
CONFIGS = {
    "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
    "Simple": TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    "FIR": dataclasses.replace(_FIR, track_peaks=False),
    "FIR-peaks": _FIR,
}


def stream(cfg, C, seed):
    """Two windows of T ticks: pulses over every chunk boundary (one over
    the window split), a chunk that overflows K, threshold-on-collection
    memory factors for the RS families."""
    if cfg.algorithm == Algorithm.FIR:
        return fir_stream(2 * T, C, TC, K, seed), 0
    return tpg_stream(2 * T, C, TC, K, seed)


def test_positions_match_jax():
    for C in (128, 256, 2560):
        pos = wibeth.words14_positions(C)
        np.testing.assert_array_equal(pos, jtpg.words14_positions(C))
        inv = wibeth.words14_channel_of_position(C)
        np.testing.assert_array_equal(inv,
                                      jtpg.words14_channel_of_position(C))
        np.testing.assert_array_equal(inv[pos], np.arange(C))


@pytest.mark.parametrize("C,block", [(128, None), (256, None), (2560, 16)])
def test_state_converter_round_trips_fused_stack(C, block):
    """A JAX fused-mode stack (words14 positions, 16-row blocks at APA
    scale) -> the port's canonical state -> the same stack; without the
    positions the non-canonical stack is refused, not truncated."""
    adcs, rmf = tpg_stream(TC, C, TC, K, seed=C)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    st["fir_prev"] = np.arange(8 * C, dtype=np.int32).reshape(8, C)
    pos = jtpg.words14_positions(C)
    stack = np.asarray(jtpg.pack_state(st, C, block_sublanes=block,
                                       positions=pos))
    state = tpg.state_from_jax(stack, C, positions=pos)
    assert torch.equal(state, tpg.pack_state(st, C))
    np.testing.assert_array_equal(
        tpg.state_to_jax(state, block_sublanes=block, positions=pos), stack)
    with pytest.raises(ValueError, match="positions"):
        tpg.state_from_jax(stack, C)
    canon = np.asarray(jtpg.pack_state(st, C))
    with pytest.raises(ValueError, match="positions"):
        tpg.state_from_jax(canon, C, positions=pos)


def test_pack_and_unpack_words14():
    """torch pack_words14 == native.relayout_words14 == pack_words14_jnp
    (G > 128 lane padding included), and the torch words14 unpack gives
    the frame unpack's samples in canonical order."""
    rng = np.random.default_rng(11)
    for L, n in [(2, 64), (33, 96), (40, 65)]:
        words = rng.integers(0, 2 ** 32, size=(L, n, 28), dtype=np.uint32)
        ref = native.relayout_words14(words)
        np.testing.assert_array_equal(
            ingest.pack_words14(torch.from_numpy(words.view(np.int32)))
            .numpy(), ref)
        np.testing.assert_array_equal(
            np.asarray(jingest.pack_words14_jnp(words)), ref)
        C = 64 * L
        want = tpg.unpack_packed14(torch.from_numpy(words.view(np.int32)),
                                   "frames", C)
        got = wibeth.unpack_words14(torch.from_numpy(ref), C)
        assert torch.equal(got, want)
        assert int(got.max()) < (1 << 14) and int(got.min()) >= 0


def jax_nclose(nclose, pos):
    n = np.asarray(nclose)
    return n.transpose(1, 0, 2, 3).reshape(n.shape[1], -1)[:, pos]


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("feed", ["fused", "words14"])
def test_packed_ingest_matches_jax(feed, name, C):
    cfg = CONFIGS[name]
    adcs, rmf = stream(cfg, C, seed=C + 7)
    pos = jtpg.words14_positions(C)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    stack = jtpg.pack_state(st, C, positions=pos)
    state = tpg.pack_state(st, C)
    total_drop = 0
    for b in range(2):
        words = frame_words(adcs[b * T:(b + 1) * T])
        if feed == "fused":
            js, jn, stack = jingest.process_packed_frames_fused(
                jnp.asarray(words), stack, cfg, C, tc=TC, k_slots=K,
                unroll=1, interpret=True)
            ps, pn, state = ingest.process_packed_frames_fused(
                torch.from_numpy(words.view(np.int32)), state, cfg, C,
                tc=TC, k_slots=K)
        else:
            W = native.relayout_words14(words)
            js, jn, stack = jingest.process_words14_feed(
                jnp.asarray(W), stack, cfg, C, tc=TC, k_slots=K, unroll=1,
                interpret=True)
            ps, pn, state = ingest.process_words14_feed(
                torch.from_numpy(W), state, cfg, C, tc=TC, k_slots=K)
        j_hits, j_drop = jtpg.decode_pallas_hits(js, jn, C, tick_offset=b * T,
                                                 positions=pos)
        hits, drop = ingest.decode_slots(ps, pn, C, tick_offset=b * T)
        np.testing.assert_array_equal(hits, j_hits)
        assert drop == j_drop
        np.testing.assert_array_equal(pn.numpy(), jax_nclose(jn, pos))
        assert torch.equal(state, tpg.state_from_jax(np.asarray(stack), C,
                                                     positions=pos))
        total_drop += drop
        assert len(hits) > 0
    assert total_drop > 0                   # the burst chunk overflows K


@pytest.mark.parametrize("feed", ["fused", "words14"])
def test_packed_ingest_matches_oracle(feed):
    """tests/test_ingest.py::TestFusedWords14 on the port: bit-exact hits
    and carried state against ops/reference.py across the links."""
    C, L = 128, 2
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    adcs[40:48, 17] += 2000
    adcs[100:120, 70] += 1500
    words = frame_words(adcs)
    assert words.shape == (L, T, 28)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0],
                                          cfg.rs_memory_factor_x10), C)
    if feed == "fused":
        slots, nclose, s1 = ingest.process_packed_frames_fused(
            torch.from_numpy(words.view(np.int32)), state, cfg, C, tc=64,
            k_slots=16)
    else:
        slots, nclose, s1 = ingest.process_words14_feed(
            torch.from_numpy(native.relayout_words14(words)), state, cfg, C,
            tc=64, k_slots=16)
    hits, dropped = ingest.collect_hits(slots, nclose, C)
    ref, ref_st = run_reference(adcs, cfg, window=T)
    assert dropped == 0 and len(ref) > 30
    np.testing.assert_array_equal(hits, ref)
    got = tpg.unpack_state(s1)
    for k in ("pedestals", "accum", "rs", "pedestals_rs", "accum_rs",
              "hit_charge", "hit_tover", "hit_peak_adc", "hit_peak_time"):
        np.testing.assert_array_equal(got[k], np.asarray(ref_st[k]),
                                      err_msg=k)


def test_packed14_wrapper_contract():
    """The wrapper's packed encodings: plain version == the unpacked
    feed's; K4 in the launch accounting; malformed inputs raise."""
    C = 128
    cfg = CONFIGS["AbsRS"]
    adcs, rmf = tpg_stream(T, C, TC, K, seed=5)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C)
    words = torch.from_numpy(frame_words(adcs).view(np.int32))
    want = tpg.process_window(torch.from_numpy(adcs), state, cfg, TC, K,
                              time_packed=False)
    for layout, feed in (("frames", words),
                         ("words14", ingest.pack_words14(words))):
        got = tpg.process_window(feed, state, cfg, TC, K, time_packed=False,
                                 packed14=layout)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tpg.kernels_of(cfg, False, "frames") == ("K4",)
    assert tpg.kernels_of(CONFIGS["FIR"], False, "words14") == ("K4", "K3")
    assert tpg.process_window.launches == 0           # CPU: no launch
    bad = [dict(feed=words, packed14="frames", time_packed=True),
           dict(feed=words, packed14="words"),
           dict(feed=words[:, :, :27].contiguous(), packed14="frames"),
           dict(feed=words[:1], packed14="frames"),       # 64 of 128 ch
           dict(feed=words, packed14="words14")]
    for kw in bad:
        kw.setdefault("time_packed", False)
        with pytest.raises(ValueError):
            tpg.process_window(state=state, cfg=cfg, tc=TC, k_slots=K, **kw)
    with pytest.raises(ValueError, match="16-channel"):
        tpg.process_window(words, state[:, :120].contiguous(), cfg, TC, K,
                           time_packed=False, packed14="frames")
