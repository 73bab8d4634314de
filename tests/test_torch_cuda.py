"""The hand-written CUDA kernel against its plain version on the card (K1,
K2 and K3: both datapaths, all four families; K4: both packed layouts, all
four families), and the APA app (every feed), ``StreamingIngest`` and the
WIB2 processors on the card against the same on the CPU.  Marked ``cuda``:
each test skips where torch finds no card.  This file imports no JAX, so on
the machine with the card (which has none) run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest, pack_words14
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import fir_stream, frame_words, \
    time2_words, tpg_stream, wib2_superchunks

pytestmark = pytest.mark.cuda

CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=-5,
              peak_gated=True),                  # charge floor + gated peak
    TPGConfig.from_raw("AbsRS", threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
]
_FIR = TPGConfig.from_raw("FIR", threshold=5)
FIR_CONFIGS = [
    dataclasses.replace(_FIR, track_peaks=False),
    dataclasses.replace(_FIR, peak_gated=True),
    dataclasses.replace(_FIR, fir_avx_semantics=False),
    dataclasses.replace(_FIR, threshold=1000, track_peaks=False,
                        taps=(3, -2, 9, 27, 9, -2, 3, 0)),
]
IDS = ["Simple", "Simple-gated-neg", "AbsRS", "StandardRS", "FIR",
       "FIR-peaks-gated", "FIR-naive", "FIR-taps-wrapped-threshold"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("time_packed", [True, False],
                         ids=["time2", "plain"])
@pytest.mark.parametrize("cfg", CONFIGS + FIR_CONFIGS, ids=IDS)
@pytest.mark.parametrize("C,stride,T,tc", [(2560, 2560, 1024, 256),
                                           (200, 256, 1000, 200)])
def test_kernel_matches_plain(card, cfg, C, stride, T, tc, time_packed):
    """tc=200 leaves an 8-tick tail group in every chunk (the FIR ring's
    realignment); stride > C reads a padded feed."""
    k = 4
    if cfg.algorithm == Algorithm.FIR:
        adcs, rmf = fir_stream(T, C, tc, k, seed=C), 0
    else:
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C)
    rows = time2_words(adcs) if time_packed else adcs
    words = np.zeros((rows.shape[0], stride), np.int32)
    words[:, :C] = rows
    feed = torch.from_numpy(words).to(card)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, device=card)
    before = dict(tpg.process_window.kernel_launches)
    got = tpg.process_window(feed, state, cfg, tc=tc, k_slots=k,
                             time_packed=time_packed)
    for name in tpg.kernels_of(cfg, time_packed):
        assert tpg.process_window.kernel_launches[name] == before[name] + 1
    want = tpg.process_window_plain(feed, state, cfg, tc, k, time_packed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) > k                  # drops exercised


@pytest.mark.parametrize("time_packed", [True, False],
                         ids=["time2", "plain"])
@pytest.mark.parametrize("tc", [6, 12, 40])
def test_kernel_short_chunks_match_plain(card, tc, time_packed):
    """Chunks shorter than one 16-tick group (a WIB2 batch of one
    superchunk is 12 ticks) or with a ragged tail: the FIR ring is
    realigned after every chunk."""
    C, T = 300, 240
    adcs = fir_stream(T, C, 120, 1, seed=tc)
    cfg = dataclasses.replace(_FIR, track_peaks=False)
    feed = torch.from_numpy(time2_words(adcs) if time_packed
                            else adcs).to(card)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C,
                           device=card)
    got = tpg.process_window(feed, state, cfg, tc=tc, k_slots=1,
                             time_packed=time_packed)
    want = tpg.process_window_plain(feed, state, cfg, tc, 1, time_packed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0][:, :, -1] != 0).sum()) > 0


@pytest.mark.parametrize("layout", ["frames", "words14"])
@pytest.mark.parametrize("cfg", CONFIGS + FIR_CONFIGS, ids=IDS)
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (192, 1000, 200)])
def test_k4_matches_plain(card, cfg, C, T, tc, layout):
    """K4, the in-kernel 14-bit unpack: the frame words (L, T, 28) as they
    are and the words14 rows (T, WR, 7, 128; 12 of 128 lanes live at
    C=192), every family; tc=200 leaves a ragged 8-tick tail group."""
    k = 4
    if cfg.algorithm == Algorithm.FIR:
        adcs, rmf = fir_stream(T, C, tc, k, seed=C + 1), 0
    else:
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C + 1)
    words = torch.from_numpy(frame_words(adcs).view(np.int32))
    feed = (words if layout == "frames" else pack_words14(words)).to(card)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, device=card)
    before = dict(tpg.process_window.kernel_launches)
    got = tpg.process_window(feed, state, cfg, tc=tc, k_slots=k,
                             time_packed=False, packed14=layout)
    for name in tpg.kernels_of(cfg, False, layout):
        assert tpg.process_window.kernel_launches[name] == before[name] + 1
    assert torch.equal(tpg.unpack_packed14(feed, layout, C).cpu(),
                       torch.from_numpy(adcs))
    want = tpg.process_window_plain(feed, state, cfg, tc, k, False, layout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) > k                  # drops exercised


FEEDS = {"time2": dict(time2_feed=True), "fused": dict(fused_unpack=True),
         "words14": dict(words14_feed=True), "packed": {}}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_app_on_card_matches_cpu(card, feed):
    rng = np.random.default_rng(4)
    batches = [make_batch(rng, 4, 16, b, 0x1000000 + b * 16 * 2048)[0]
               for b in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        app = APAReadoutApp(n_links=4, algorithm="AbsRS", threshold=150,
                            threshold_on_collection=True, device=dev,
                            **FEEDS[feed])
        fetched = []
        fetch = app._fetch_hits

        def recording_fetch(packed, fetch=fetch, fetched=fetched):
            fetched.append(fetch(packed))
            return fetched[-1]

        app._fetch_hits = recording_fetch
        for frames in batches:
            app.process_batch(frames.copy())
        out[dev] = (fetched, app.handler.buffer.snapshot())
    for (ha, da), (hb, db) in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("mode", ["packed", "fused", "words14", "time2"])
def test_streaming_ingest_on_card_matches_cpu(card, mode):
    """StreamingIngest over 3 pipelined batches of 4 WIBEth links, device
    compaction on: the hits and the carried state equal the CPU's."""
    n_links, T = 4, 512
    adcs, rmf = tpg_stream(3 * T, 64 * n_links, 256, 4, seed=9)
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    out = {}
    for dev in ("cuda", "cpu"):
        ing = StreamingIngest(cfg, n_links, k_slots=4, device_compact=True,
                              rs_memory_factor=rmf, device=dev,
                              fused=mode in ("fused", "words14"),
                              time2=mode == "time2")
        res = []
        for b in range(3):
            words = frame_words(adcs[b * T:(b + 1) * T])
            res.append(ing.submit_words14(native.relayout_words14(words))
                       if mode == "words14" else ing.submit_words(words))
        res.append(ing.flush())
        out[dev] = (res[1:], ing.state.cpu())
    for (ha, da), (hb, db) in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    assert sum(len(h) for h, _ in out["cpu"][0]) > 0
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_wib2_processors_on_card_match_cpu(card):
    """Two WIB2 links, FIR, packed and time2 ingest, three batches with the
    state carried on the device: the TPs and counters equal the same
    processors' on the CPU (the plain version)."""
    batches = [wib2_superchunks(2, 16, seed=b, ts0=0x1000000 + b * 16 * 384)[0]
               for b in range(3)]
    for time2 in (False, True):
        out = {}
        for dev in ("cuda", "cpu"):
            tps, counts = [], []
            for link in range(2):
                sink = QueueSender()
                p = WIB2FrameProcessor(tp_sink=sink, device=dev)
                p.conf({"crate_id": 1, "slot_id": 0, "link_id": link,
                        "enable_tpg": True, "tpg_algorithm": "FIR",
                        "tpg_threshold": 5, "tp_timeout": 100_000,
                        "tpg_time2_feed": time2})
                p.start()
                for sc in batches:
                    p.process(sc[link].copy())
                tps.append(np.concatenate(sink.drain()))
                counts.append({k: p.metrics.count(k) for k in (
                    "num_hits", "num_hits_dropped", "num_tps_sent",
                    "num_ts_errors")})
            out[dev] = (tps, counts)
        for a, b in zip(out["cuda"][0], out["cpu"][0]):
            assert len(a) > 0
            np.testing.assert_array_equal(a, b)
        assert out["cuda"][1] == out["cpu"][1]
