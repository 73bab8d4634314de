"""The port's StreamingIngest (device="cpu": the kernel's plain version)
against the JAX package's (Pallas interpret mode) over three pipelined
batches, for every runnable ingest mode, with device compaction on and off:
the hits and dropped counts each submit returns and the carried state must
be equal (tolerance 0).  The JAX fused mode keeps its state in words14
lane positions; the port keeps canonical order."""

import dataclasses

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import TPGConfig
from fdreadoutlibs_tpu.ops.ingest import StreamingIngest as JaxIngest
from fdreadoutlibs_tpu_torch.formats import wib2, wibeth
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             tpg_stream)

torch.set_num_threads(1)

L, N, TC, K, BATCHES = 2, 4, 64, 2, 3
T = N * 64                                   # WIBEth ticks per batch
WIB2_T = 192                                 # WIB2 frames (ticks) per batch
ABS = TPGConfig.from_raw("AbsRS", threshold=150)
FIR = dataclasses.replace(TPGConfig.from_raw("FIR", threshold=5),
                          track_peaks=False)
MODES = {"wibeth": dict(format="wibeth"),
         "wibeth-fused": dict(format="wibeth", fused=True),
         "wibeth-time2": dict(format="wibeth", time2=True),
         "wibeth-words14": dict(format="wibeth", fused=True),
         "wib2": dict(format="wib2"),
         "wib2-time2": dict(format="wib2", time2=True)}


def wibeth_batches(seed):
    """Consecutive (L, N, 7200) frame batches of one tpg_stream (pulses
    over every batch split, a K overflow) and its memory factors."""
    adcs, rmf = tpg_stream(BATCHES * T, L * 64, TC, K, seed)
    out = []
    for b in range(BATCHES):
        words = frame_words(adcs[b * T:(b + 1) * T])         # (L, T, 28)
        frames = np.zeros((L, N, wibeth.FRAME_SIZE), np.uint8)
        wibeth.adc_region_u32(frames)[...] = words.reshape(L, N, 64, 28)
        out.append(frames)
    return out, rmf


def wib2_batches(seed):
    adcs = fir_stream(BATCHES * WIB2_T, wib2.N_CHANNELS, TC, K, seed)
    out = []
    for b in range(BATCHES):
        frames = wib2.empty_frames(WIB2_T)
        wib2.set_adcs(frames, adcs[b * WIB2_T:(b + 1) * WIB2_T])
        out.append(frames[None])
    return out


def drive(ing, batches, mode):
    outs = []
    for frames in batches:
        if mode == "wibeth-words14":
            words = wibeth.frames_bytes_to_u32(
                frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(L, T, 28)
            outs.append(ing.submit_words14(native.relayout_words14(words)))
        else:
            outs.append(ing.submit(frames.copy()))
    outs.append(ing.flush())
    assert outs[0] is None
    return outs[1:]


@pytest.mark.parametrize("compact", [False, True], ids=["host", "compact"])
@pytest.mark.parametrize("mode", list(MODES))
def test_streaming_ingest_matches_jax(mode, compact):
    kw = dict(MODES[mode], tc=TC, k_slots=K, device_compact=compact,
              max_hits=512)
    if mode.startswith("wibeth"):
        batches, rmf = wibeth_batches(seed=41)
        cfg, n_links = ABS, L
        kw["rs_memory_factor"] = rmf
    else:
        batches, cfg, n_links = wib2_batches(seed=43), FIR, 1
    port = StreamingIngest(cfg, n_links, device="cpu", **kw)
    ref = JaxIngest(cfg, n_links, interpret=True, **kw)
    got, want = drive(port, batches, mode), drive(ref, batches, mode)
    n_hits = dropped = 0
    for (h, d), (hj, dj) in zip(got, want):
        np.testing.assert_array_equal(h, hj)
        assert d == dj
        n_hits, dropped = n_hits + len(h), dropped + d
    assert n_hits > 0 and dropped > 0
    assert port.tick_offset == ref.tick_offset
    assert torch.equal(port.state, tpg.state_from_jax(
        np.asarray(ref.stack), port.n_channels, positions=ref._positions))


def test_submit_words14_matches_submit_words():
    """The direct words14 feed equals the fused frame-word feed, hit for
    hit and state for state; the non-fused ingest refuses it."""
    batches, rmf = wibeth_batches(seed=47)
    outs = {}
    for mode in ("words", "words14"):
        ing = StreamingIngest(ABS, L, tc=TC, k_slots=K, fused=True,
                              rs_memory_factor=rmf, device="cpu")
        if mode == "words":
            res = [ing.submit(f) for f in batches] + [ing.flush()]
        else:
            res = drive(ing, batches, "wibeth-words14")
        outs[mode] = ([r for r in res if r is not None], ing.state)
    for (h, d), (hw, dw) in zip(*(outs[m][0] for m in outs)):
        np.testing.assert_array_equal(h, hw)
        assert d == dw
    assert torch.equal(outs["words"][1], outs["words14"][1])
    plain = StreamingIngest(ABS, L, tc=TC, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        plain.submit_words14(native.relayout_words14(
            frame_words(np.zeros((T, L * 64), np.int32))))
    with pytest.raises(ValueError, match="fused"):
        StreamingIngest(ABS, L, format="wib2", fused=True, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        StreamingIngest(ABS, L, fused=True, time2=True, device="cpu")


def test_time2_odd_tc_and_seeding():
    """submit_time2 where auto_tc picks an odd divisor (cap 3 on 192
    ticks -> 3): the largest even divisor below it runs (2), as in the
    JAX class (:557-559), and state seeds from tick 0."""
    Tn = 3 * 64
    adcs, rmf = tpg_stream(Tn, 64, Tn, 1, seed=3)
    W2 = native.relayout_time2(frame_words(adcs), pad8=False)
    for cap in (96, 3):
        port = StreamingIngest(ABS, 1, tc=cap, device="cpu",
                               rs_memory_factor=rmf[:64])
        ref = JaxIngest(ABS, 1, tc=cap, interpret=True,
                        rs_memory_factor=rmf[:64])
        for ing in (port, ref):
            assert ing.submit_time2(W2) is None
        (h, d), (hj, dj) = port.flush(), ref.flush()
        np.testing.assert_array_equal(h, hj)
        assert d == dj
        assert torch.equal(port.state, tpg.state_from_jax(
            np.asarray(ref.stack), 64))
