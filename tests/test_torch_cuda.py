"""The hand-written CUDA kernel against its plain version on the card (K1,
K2 and K3: both datapaths, all four families; K4: both packed layouts, all
four families; the pipeline of K1-K5, K2b and K4b launched 50 times
each for races (K2b at an even and an odd feed stride), and the staged
arms; that K1, K2b, K3b and K4b launch the pipeline, by ``tpg.kernel_of``
and the machine code's kernel names; K5: fir_twopass 1 and 2 on every
encoding, also against K3, and through the words14 gather; K2b, K3b,
K4b-gather, K4b-slab (K3b and K4b-slab also at a 1024-tick chunk) and
the float running sum; the ``SLOT_WORD_CARRY`` layout on every one of those
datapaths; the probes' kernels P1-P3), and the APA app (every feed; its
CUDA-event spans, read complete after the fetch),
``StreamingIngest``, the WIB2 and
ProtoWIB processors and ``run_model`` on the card against the same on the
CPU; for the detector slice, K2 at the PDS and TDE widths (40, 64 and 62
channels; 512- and 333-tick windows), the PDS app (sync and pipelined),
the DAPHNE-stream processor and the three-arm detector app on the card
against the same on the CPU; for the modules slice, ``MultiAPAScheduler``
at 4 APAs x 4 links against single-APA ``StreamingIngest`` and its CPU run,
``entry()``, the CLI's ``tpg-emulator -i pallas``, ``compare-backends`` and
``profile`` (the trace names the kernel), and checkpoint/resume with the
state on the card; for the parallel slice, ``APAPipeline`` on 8 shards of
the card against 1 shard and a CPU mesh in each ingest,
``DetectorPipeline`` on the card against the CPU, the sharded resume from
the card onto the card and the CPU, ``dryrun_multichip`` on the card
against its CPU line, and the C entries leaving the caller's device as
they found it (needs 2 cards); for the tool slice, the tpg library of a
non-shipped geometry against the shipped one and the plain version, the
tuner, the semantic fuzz and the malformed-frame fuzz on the card; for the
bench, its kernel cells at 2560 x 8192 (parity with the plain version), a
failing cell's exit code, and the slab at a tuned group that does not
divide tc (the shipped library, with a warning).  Marked ``cuda``:
each test skips where torch finds no card.  This file imports no JAX, so on
the machine with the card (which has none) run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu_torch import native
from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.models import run_model
from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, init_chanstate,
                                         seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest, pack_words14
from fdreadoutlibs_tpu_torch import probes
from fdreadoutlibs_tpu_torch.probes import (fir_pipe, i16_ops, roofline,
                                            slots_ab, swar_frugal)
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor, \
    WIBFrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import fir_stream, frame_words, \
    protowib_superchunks, time2_words, tpg_stream, wib2_superchunks
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
from fdreadoutlibs_tpu_torch.utils import tuning
from fdreadoutlibs_tpu_torch.utils.tuning import Geometry

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


@pytest.fixture(scope="module")
def tpg_functions():
    """The kernel functions of the card's tpg library, by mangled name
    (``cuobjdump -sass``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from fdreadoutlibs_tpu_torch.ops import _build
    return set(fir_pipe._FUNC.findall(_build.sass("tpg")))


# csrc/tpg.cuh's encodings of the variants of the fused tick that the
# symbol checks follow (K3b's is its feed's)
_PIPE_ENCODING = {"K1": 1, "K2b": 5, "K4b-gather": 3, "K4b-slab": 4}


def _assert_pipeline(functions, kernel, cfg, carry, kw):
    """K1 (encoding 1), K2b (5), K4b-gather (3), K4b-slab (4) and K3b (on
    the encoding of its feed, ``kw`` as ``process_window`` took it:
    FirPackedChannel in K3's mode) are instantiated as the pipeline
    (``pipe_kernel``, the threshold mode, K3's for FIR) with this emission
    layout, and the library holds no one-thread-per-channel tick
    (``tpg_kernel``, ``tpg_slab_kernel``) to fall back to."""
    channel = ""
    if kernel == "K3b":
        enc = 4 if kw.get("words14_slab") else \
            3 if kw.get("words14_gather") else \
            2 if kw.get("packed14") else 1 if kw["time_packed"] else 0
        channel = "16FirPackedChannel"
    else:
        enc = _PIPE_ENCODING[kernel]
    mode = 1 if cfg.algorithm == Algorithm.FIR else 4
    tail = f"ELb{int(carry)}EEEvN3tpg6ParamsE"
    assert any(re.search(rf"pipe_kernelILi{enc}ELi{mode}EN\w*?{channel}", f)
               and f.endswith(tail) for f in functions), (kernel, enc, kw)
    back = [f for f in functions
            if re.search(r"\d(?:tpg_kernel|tpg_slab_kernel)I", f)]
    assert back == [], back


@pytest.mark.parametrize("time_packed", [True, False],
                         ids=["time2", "plain"])
@pytest.mark.parametrize("cfg", CONFIGS + FIR_CONFIGS, ids=IDS)
@pytest.mark.parametrize("C,stride,T,tc", [(2560, 2560, 1024, 256),
                                           (200, 256, 1000, 200),
                                           (96, 96, 336, 112),
                                           (160, 160, 300, 150)])
def test_kernel_matches_plain(card, cfg, C, stride, T, tc, time_packed):
    """tc=200 leaves an 8-tick tail group in every chunk (the FIR ring's
    realignment); stride > C reads a padded feed; 96 and 160 channels are a
    ProtoWIB plane's, with chunks that are no whole 32-tick stage of the
    FIR pipeline (tc = 112, 150)."""
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


def test_app_device_spans_on_card(card):
    """The pipelined app's CUDA-event spans: each row's TPG launch and
    compaction read positive device times, and every event had completed
    when its time was read (right after the fetch, no sync of its own)."""
    read = []

    class Checked(torch.cuda.Event):
        def elapsed_time(self, end_event):
            read.append(self.query() and end_event.query())
            return super().elapsed_time(end_event)

    rng = np.random.default_rng(6)
    app = APAReadoutApp(n_links=4, algorithm="AbsRS", threshold=150,
                        threshold_on_collection=True, time2_feed=True,
                        pipelined=True, device="cuda")
    app._events = [tuple(Checked(enable_timing=True) for _ in range(4))
                   for _ in range(2)]
    for b in range(5):
        app.process_batch(make_batch(rng, 4, 16, b,
                                     0x1000000 + b * 16 * 2048)[0])
    app.flush()
    rows = list(app.batch_timings)
    assert len(rows) == 5 and len(read) == 10 and all(read)
    for row in rows:
        assert row["tpg_device_ms"] > 0 and row["compact_device_ms"] > 0
        assert "device_ms" not in row


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


@pytest.mark.parametrize("fir_twopass", [1, 2])
@pytest.mark.parametrize("cfg", FIR_CONFIGS, ids=IDS[len(CONFIGS):])
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (208, 1000, 200),
                                   (96, 336, 112), (160, 300, 150)])
def test_k5_matches_k3_and_plain(card, cfg, C, T, tc, fir_twopass):
    """K5, the two-pass FIR schedule, on every encoding (plain, time2,
    frame words, words14 rows): bit-equal to its plain version and to K3
    on the same inputs.  C = 208 leaves the last 32-channel block partly
    empty; tc = 200 is no whole number of 16-tick groups; 96 and 160
    channels (a ProtoWIB plane) with tc = 112 and 150, no whole number of
    32-tick stages."""
    k = 4
    adcs = fir_stream(T, C, tc, k, seed=C + 2)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C,
                           device=card)
    words = torch.from_numpy(frame_words(
        np.pad(adcs, ((0, 0), (0, -C % 64)))).view(np.int32))
    feeds = [(torch.from_numpy(adcs), False, None),
             (torch.from_numpy(time2_words(adcs)), True, None),
             (words, False, "frames"), (pack_words14(words), False,
                                        "words14")]
    want = tpg.process_window_twopass_plain(feeds[0][0].to(card), state, cfg,
                                            tc, k, fir_twopass, False)
    for feed, time2, packed14 in feeds:
        feed = feed.to(card)
        before = tpg.process_window.kernel_launches["K5"]
        got = tpg.process_window(feed, state, cfg, tc, k, time2, packed14,
                                 fir_twopass=fir_twopass)
        assert tpg.process_window.kernel_launches["K5"] == before + 1
        fused = tpg.process_window(feed, state, cfg, tc, k, time2, packed14)
        for g, w, f in zip(got, want, fused):
            assert torch.equal(g, w), (time2, packed14)
            assert torch.equal(g, f), (time2, packed14)
    assert int(want[1].max()) > k                 # drops exercised


@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (160, 300, 150)])
def test_fir_pipeline_is_deterministic(card, C, T, tc):
    """The FIR pipeline's warps meet only at its stage barriers: K3 on
    plain and time2 rows and K5 under fir_twopass 1 and 2, each launched 50
    times on the same inputs, give bit-identical slots, nclose and state
    every time, equal to the plain version."""
    cfg = FIR_CONFIGS[1]
    k = 4
    adcs = fir_stream(T, C, tc, k, seed=C + 5)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C,
                           device=card)
    plain = torch.from_numpy(adcs).to(card)
    want = tpg.process_window_plain(plain, state, cfg, tc, k, False)
    assert int(want[1].max()) > k                 # drops exercised
    for feed, time2, twopass in ((plain, False, 0),
                                 (torch.from_numpy(time2_words(adcs)).to(
                                     card), True, 0),
                                 (plain, False, 1), (plain, False, 2)):
        runs = [tpg.process_window(feed, state, cfg, tc, k, time2,
                                   fir_twopass=twopass) for _ in range(50)]
        torch.cuda.synchronize()
        for got in runs:
            for g, w in zip(got, want):
                assert torch.equal(g, w), (time2, twopass)


def _threshold_feeds(adcs, C):
    """The window on plain rows, frame words (padded to whole links) and
    words14 rows: K2's and K4's feeds."""
    words = torch.from_numpy(frame_words(
        np.pad(adcs, ((0, 0), (0, -C % 64)))).view(np.int32))
    return [(torch.from_numpy(adcs), None), (words, "frames"),
            (pack_words14(words), "words14")]


def _threshold_runs(adcs, state, C, card):
    """(feed, state, time2, packed14) on the card: K2's plain rows, K4's
    frame words and words14 rows, K1's time2 rows, and K2b's int16 samples
    and state at the feed's own stride and one column wider (an even and
    an odd stride for even C: the word copies and the per-lane loads)."""
    runs = [(f.to(card), state, False, p) for f, p in
            _threshold_feeds(adcs, C)]
    runs.append((torch.from_numpy(time2_words(adcs)).to(card), state, True,
                 None))
    s16 = state.to(torch.int16)
    assert torch.equal(s16.to(torch.int32), state)
    a16 = torch.from_numpy(adcs.astype(np.int16))
    for pad in (0, 1):
        runs.append((torch.nn.functional.pad(a16, (0, pad)).contiguous().to(
            card), s16, False, None))
    return runs


@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (160, 300, 150)])
def test_threshold_pipeline_is_deterministic(card, C, T, tc):
    """The threshold pipeline's warps meet only at its stage barriers: K2,
    K4 (frame words, words14 rows), K1 (time2 rows) and K2b (int16 samples
    and state, an even and an odd feed stride) for AbsRS (three warps) and
    SimpleThreshold (two), each launched 50 times on the same inputs, give
    bit-identical slots, nclose and state every time, equal to the plain
    version (the int16 state widened: 14-bit streams stay in range)."""
    k = 4
    for cfg in (CONFIGS[2], CONFIGS[0]):
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C + 6)
        state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0],
                                              rmf), C, device=card)
        want = tpg.process_window_plain(torch.from_numpy(adcs).to(card),
                                        state, cfg, tc, k, False)
        assert int(want[1].max()) > k             # drops exercised
        for feed, s0, time2, packed14 in _threshold_runs(adcs, state, C,
                                                         card):
            runs = [tpg.process_window(feed, s0, cfg, tc, k, time2,
                                       packed14) for _ in range(50)]
            torch.cuda.synchronize()
            for got in runs:
                for g, w in zip(got, want):
                    assert torch.equal(g.to(w.dtype), w), \
                        (cfg.algorithm, time2, packed14, tuple(feed.shape))


@pytest.mark.parametrize("cfg", CONFIGS + [
    TPGConfig.from_raw("AbsRS", threshold=150, rs_float=True)],
    ids=IDS[:len(CONFIGS)] + ["AbsRS-float"])
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (160, 300, 150)])
def test_threshold_staged_arm_matches_plain(card, cfg, C, T, tc):
    """The threshold pipeline's staged arm (``probes.fir_pipe.
    staged_launch``: one warp copies the feed into the ring and runs
    ThresholdChannel's whole tick) on plain samples, frame words, words14
    rows, time2 rows and int16 samples and state (an even and an odd feed
    stride) against its plain version, and the launches counted."""
    k = 4
    adcs, rmf = tpg_stream(T, C, tc, k, seed=C + 8)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, device=card)
    want = tpg.process_window_plain(torch.from_numpy(adcs).to(card), state,
                                    cfg, tc, k, False)
    before = fir_pipe.launches
    runs = _threshold_runs(adcs, state, C, card)
    for feed, s0, time2, packed14 in runs:
        got = fir_pipe.staged_launch(feed, s0, cfg, tc, k, time2, packed14)
        for g, w in zip(got, want):
            assert torch.equal(g.to(w.dtype), w), \
                (time2, packed14, tuple(feed.shape))
    assert fir_pipe.launches == before + len(runs) == before + 6
    assert int((want[0][:, :, -1] != 0).sum()) > 0


def _tuned(tmp_path, monkeypatch, twopass):
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"FIR": {"twopass": twopass}}))
    monkeypatch.setenv("FDREADOUT_TUNED", str(path))


@pytest.mark.parametrize("twopass", [0, 1, 2])
def test_protowib_processor_on_card_matches_cpu(card, twopass, tmp_path,
                                                monkeypatch):
    """Two ProtoWIB links' processors, packed and time2 feeds, three
    batches, under a tuned file naming ``twopass``: the TPSets and
    counters on the card equal the CPU's (the plain version)."""
    _tuned(tmp_path, monkeypatch, twopass)
    batches = [protowib_superchunks(2, 16, seed=b,
                                    ts0=0x1000000 + b * 16 * 300)[0]
               for b in range(3)]
    for time2 in (False, True):
        out = {}
        for dev in ("cuda", "cpu"):
            tpg.reset_launches()
            objs, counts = [], []
            for link in range(2):
                h = WIBTPHandler(tp_timeout=2_000, tpset_window_size=500)
                p = WIBFrameProcessor(tp_handler=h, device=dev)
                p.conf({"link_id": link, "enable_tpg": True,
                        "tpg_time2_feed": time2, "tpg_k_slots": 2})
                p.start()
                for sc in batches:
                    p.process(sc[link].copy())
                while (s := h.try_sending_tpsets(10**12)) is not None:
                    objs.append(s.objects)
                counts.append({k: p.metrics.count(k) for k in (
                    "num_hits", "num_hits_dropped", "num_tps_sent",
                    "num_ts_errors")})
            out[dev] = (objs, counts, dict(tpg.process_window.kernel_launches))
        assert len(out["cuda"][0]) == len(out["cpu"][0]) > 0
        for a, b in zip(out["cuda"][0], out["cpu"][0]):
            np.testing.assert_array_equal(a, b)
        assert out["cuda"][1] == out["cpu"][1]
        assert out["cuda"][1][0]["num_hits"] > 0
        # one launch per plane per link per batch
        assert out["cuda"][2]["K5" if twopass else "K3"] == 2 * 2 * 3


@pytest.mark.parametrize("time2", [False, True])
def test_protowib_device_spans_on_card(card, time2):
    """The ProtoWIB processor's CUDA-event spans: each row's FIR launches
    and compactions read positive device times, and every event had
    completed when its time was read (after the fetch, no sync of its
    own)."""
    read = []

    class Checked(torch.cuda.Event):
        def elapsed_time(self, end_event):
            read.append(self.query() and end_event.query())
            return super().elapsed_time(end_event)

    p = WIBFrameProcessor(tp_handler=WIBTPHandler(), device="cuda")
    p.conf({"enable_tpg": True, "tpg_time2_feed": time2})
    p.start()
    p._events = {key: [tuple(Checked(enable_timing=True) for _ in range(2))
                       for _ in pairs]
                 for key, pairs in p._events.items()}
    for b in range(3):
        sc = protowib_superchunks(1, 16, seed=b,
                                  ts0=0x1000000 + b * 16 * 300)[0]
        p.process(sc[0].copy())
    rows = list(p.batch_timings)
    planes = 2 if time2 else 1
    assert len(rows) == 3 and len(read) == 3 * (planes + 1) and all(read)
    for row in rows:
        assert row["fir_device_ms"] > 0 and row["compact_device_ms"] > 0


@pytest.mark.parametrize("twopass", [0, 2])
def test_run_model_on_card_matches_cpu(card, twopass, tmp_path, monkeypatch):
    _tuned(tmp_path, monkeypatch, twopass)
    cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    adcs = fir_stream(1100, 160, 128, 2, seed=12)
    for backend in ("scan", "pallas"):
        hits, st = run_model(adcs, cfg, backend, device="cuda")
        want, want_st = run_model(adcs, cfg, backend, device="cpu")
        assert len(want) > 0
        np.testing.assert_array_equal(hits, want)
        for key in want_st:
            np.testing.assert_array_equal(st[key], want_st[key])


RS_FLOAT_CONFIGS = [
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150, rs_float=True),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=60, rs_float=True),
]
VARIANT_CONFIGS = CONFIGS + FIR_CONFIGS + RS_FLOAT_CONFIGS
VARIANT_IDS = IDS + ["AbsRS-float", "StandardRS-float"]


def _variant_inputs(cfg, C, T, tc, k, card):
    if cfg.algorithm == Algorithm.FIR:
        adcs, rmf = fir_stream(T, C, tc, k, seed=C + 3), 0
    else:
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C + 3)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    # whole 64-channel links of frame words; the kernels read the first C
    padded = np.pad(adcs, ((0, 0), (0, -C % 64)), constant_values=900)
    words = torch.from_numpy(frame_words(padded).view(np.int32))
    return adcs, st, pack_words14(words).to(card)


@pytest.mark.parametrize("cfg", VARIANT_CONFIGS, ids=VARIANT_IDS)
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (208, 960, 192)])
def test_variant_kernels_match_plain(card, tpg_functions, cfg, C, T, tc):
    """K4b-gather and K4b-slab on words14 rows, K2b on the int16 state and
    feed, and K3b (fir_packed) on every encoding for FIR, each against its
    plain version; the float running sum rides every one of them.  C = 208
    leaves a partly empty block and a half warp.  Each launch counts as its
    kernel (``tpg.kernel_of``: K3b whenever fir_packed is in effect), and
    K2b's, K3b's and K4b's reach the pipeline (the machine code's kernel
    names)."""
    k = 4
    adcs, st, w14 = _variant_inputs(cfg, C, T, tc, k, card)
    state = tpg.pack_state(st, C, device=card)
    runs = [(w14, state, dict(time_packed=False, packed14="words14",
                              words14_gather=True)),
            (w14, state, dict(time_packed=False, packed14="words14",
                              words14_slab=True)),
            (torch.from_numpy(adcs.astype(np.int16)).to(card),
             tpg.pack_state(st, C, device=card, dtype=torch.int16),
             dict(time_packed=False))]
    if cfg.algorithm == Algorithm.FIR:
        for kw in (dict(time_packed=False), dict(time_packed=True),
                   dict(time_packed=False, packed14="words14"),
                   dict(time_packed=False, packed14="words14",
                        words14_gather=True),
                   dict(time_packed=False, packed14="words14",
                        words14_slab=True)):
            feed = w14 if "packed14" in kw else torch.from_numpy(
                time2_words(adcs) if kw["time_packed"] else adcs).to(card)
            runs.append((feed, state, dict(kw, fir_packed=True)))
    for feed, s0, kw in runs:
        before = dict(tpg.process_window.kernel_launches)
        before_fn = dict(tpg.process_window.function_launches)
        got = tpg.process_window(feed, s0, cfg, tc=tc, k_slots=k, **kw)
        opts = {o: kw.get(o, False) for o in ("fir_packed", "words14_gather",
                                              "words14_slab")}
        int16 = s0.dtype == torch.int16
        for name in tpg.kernels_of(cfg, kw["time_packed"],
                                   kw.get("packed14"), int16=int16, **opts):
            assert tpg.process_window.kernel_launches[name] == \
                before[name] + 1, (name, kw)
        fn = tpg.kernel_of(cfg, kw["time_packed"], kw.get("packed14"),
                           int16=int16, **opts)
        assert tpg.process_window.function_launches[fn] == \
            before_fn[fn] + 1, (fn, kw)
        if int16:
            assert fn == "K2b"
        _assert_pipeline(tpg_functions, fn, cfg, False, kw)
        want = tpg.process_window_plain(feed, s0, cfg, tc, k, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), kw
        assert int(got[1].max()) > k, kw            # drops exercised


@pytest.mark.parametrize("cfg", [CONFIGS[2], FIR_CONFIGS[1]],
                         ids=["AbsRS", "FIR-peaks-gated"])
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (160, 288, 144)])
def test_k4b_pipeline_is_deterministic(card, cfg, C, T, tc):
    """K4b-gather and K4b-slab (its unpack pass and K1's front on warp 0)
    for AbsRS (three warps) and FIR (K3's two), each launched 50 times on
    the same words14 rows, give bit-identical slots, nclose and state every
    time, equal to the plain version; tc = 144 ends each chunk on a 16-tick
    stage."""
    k = 4
    adcs, st, w14 = _variant_inputs(cfg, C, T, tc, k, card)
    state = tpg.pack_state(st, C, device=card)
    want = tpg.process_window_plain(torch.from_numpy(adcs).to(card), state,
                                    cfg, tc, k, False)
    assert int(want[1].max()) > k                 # drops exercised
    for opts in (dict(words14_gather=True), dict(words14_slab=True)):
        runs = [tpg.process_window(w14, state, cfg, tc, k, False, "words14",
                                   **opts) for _ in range(50)]
        torch.cuda.synchronize()
        for got in runs:
            for g, w in zip(got, want):
                assert torch.equal(g, w), opts


@pytest.mark.parametrize("cfg", [CONFIGS[2], FIR_CONFIGS[0]],
                         ids=["AbsRS", "FIR"])
def test_k4b_slab_long_chunk_matches_plain(card, cfg):
    """K4b-slab at tc = 1024, above the 896 ticks whose time2 words of 128
    channels a block's shared memory would hold: the pipeline unpacks a
    stage at a time, so the launch is taken (direct store and carry layout)
    and equals the plain version; for FIR so is K3b on the slab
    (``fir_packed``), the same pipeline."""
    k = 4
    C, T, tc = 2560, 2048, 1024
    adcs, st, w14 = _variant_inputs(cfg, C, T, tc, k, card)
    state = tpg.pack_state(st, C, device=card)
    want = tpg.process_window_plain(w14, state, cfg, tc, k, False, "words14",
                                    words14_slab=True)
    assert int(want[1].max()) > k
    direct = tpg.process_window(w14, state, cfg, tc, k, False, "words14",
                                words14_slab=True)
    with slots_ab.slot_word_carry():
        carry = tpg.process_window(w14, state, cfg, tc, k, False, "words14",
                                   words14_slab=True)
    for g, w, c in zip(direct, want, carry):
        assert torch.equal(g, w)
        assert torch.equal(c, w)
    if cfg.algorithm == Algorithm.FIR:
        want = tpg.process_window_plain(w14, state, cfg, tc, k, False,
                                        "words14", fir_packed=True,
                                        words14_slab=True)
        direct = tpg.process_window(w14, state, cfg, tc, k, False, "words14",
                                    fir_packed=True, words14_slab=True)
        with slots_ab.slot_word_carry():
            carry = tpg.process_window(w14, state, cfg, tc, k, False,
                                       "words14", fir_packed=True,
                                       words14_slab=True)
        for g, w, c in zip(direct, want, carry):
            assert torch.equal(g, w)
            assert torch.equal(c, w)


@pytest.mark.parametrize("fir_twopass", [1, 2])
@pytest.mark.parametrize("C,T,tc", [(2560, 1024, 256), (208, 1000, 200)])
def test_k5_gather_matches_plain(card, C, T, tc, fir_twopass):
    """K5 decoding words14 rows through K4b-gather's decode."""
    cfg = FIR_CONFIGS[1]
    adcs, st, w14 = _variant_inputs(cfg, C, T, tc, 4, card)
    state = tpg.pack_state(st, C, device=card)
    got = tpg.process_window(w14, state, cfg, tc=tc, k_slots=4,
                             time_packed=False, packed14="words14",
                             fir_twopass=fir_twopass, words14_gather=True)
    want = tpg.process_window_twopass_plain(
        torch.from_numpy(adcs).to(card), state, cfg, tc, 4, fir_twopass,
        False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cfg", VARIANT_CONFIGS, ids=VARIANT_IDS)
@pytest.mark.parametrize("C,T,tc,k", [(2560, 1024, 256, 4),
                                      (208, 960, 192, 6)])
def test_slot_word_carry_matches_plain(card, tpg_functions, cfg, C, T, tc,
                                       k):
    """``SLOT_WORD_CARRY`` on every datapath the flag reaches (K1-K4, K2b,
    K3b, K4b), against the plain version and the direct store: k = 4 fills
    the register slots, k = 6 the shared-memory staging; C = 208 leaves a
    partly empty block and a half warp.  K5 ignores the flag.  K1's, K2b's,
    K3b's and K4b's carry launches reach the pipeline (``tpg.kernel_of``
    and the machine code's kernel names)."""
    adcs, st, w14 = _variant_inputs(cfg, C, T, tc, k, card)
    state = tpg.pack_state(st, C, device=card)
    padded = np.pad(adcs, ((0, 0), (0, -C % 64)), constant_values=900)
    frames = torch.from_numpy(frame_words(padded).view(np.int32)).to(card)
    runs = [(torch.from_numpy(adcs).to(card), state, dict(time_packed=False)),
            (torch.from_numpy(time2_words(adcs)).to(card), state,
             dict(time_packed=True)),
            (frames, state, dict(time_packed=False, packed14="frames")),
            (w14, state, dict(time_packed=False, packed14="words14")),
            (w14, state, dict(time_packed=False, packed14="words14",
                              words14_gather=True)),
            (w14, state, dict(time_packed=False, packed14="words14",
                              words14_slab=True)),
            (torch.from_numpy(adcs.astype(np.int16)).to(card),
             tpg.pack_state(st, C, device=card, dtype=torch.int16),
             dict(time_packed=False))]
    if cfg.algorithm == Algorithm.FIR:
        runs += [(f, s0, dict(kw, fir_packed=True)) for f, s0, kw in runs
                 if s0.dtype == torch.int32]
    for feed, s0, kw in runs:
        direct = tpg.process_window(feed, s0, cfg, tc=tc, k_slots=k, **kw)
        before = dict(tpg.process_window.carry_launches)
        with slots_ab.slot_word_carry():
            got = tpg.process_window(feed, s0, cfg, tc=tc, k_slots=k, **kw)
        opts = {o: kw.get(o, False) for o in ("fir_packed", "words14_gather",
                                              "words14_slab")}
        int16 = s0.dtype == torch.int16
        for name in tpg.kernels_of(cfg, kw["time_packed"],
                                   kw.get("packed14"), int16=int16, **opts):
            assert tpg.process_window.carry_launches[name] == \
                before[name] + 1, (name, kw)
        fn = tpg.kernel_of(cfg, kw["time_packed"], kw.get("packed14"),
                           int16=int16, **opts)
        if fn == "K3b" or fn in _PIPE_ENCODING:
            _assert_pipeline(tpg_functions, fn, cfg, True, kw)
        want = tpg.process_window_plain(feed, s0, cfg, tc, k, **kw)
        for g, w, d in zip(got, want, direct):
            assert torch.equal(g, w), kw
            assert torch.equal(g, d), kw
        assert int(got[1].max()) > k, kw            # drops exercised
    if cfg.algorithm == Algorithm.FIR:
        feed, s0, kw = runs[0]
        before = tpg.process_window.kernel_launches["K5"]
        with slots_ab.slot_word_carry():
            got = tpg.process_window(feed, s0, cfg, tc=tc, k_slots=k,
                                     fir_twopass=1, **kw)
        assert tpg.process_window.kernel_launches["K5"] == before + 1
        for g, d in zip(got, tpg.process_window(feed, s0, cfg, tc=tc,
                                                k_slots=k, **kw)):
            assert torch.equal(g, d)


def test_slot_word_carry_refuses_a_staging_too_large(card):
    """A k whose staging cannot fit a block's shared memory raises: it
    never takes the direct store quietly."""
    cfg = CONFIGS[2]
    C, T = 128, 2048
    state = tpg.pack_state(seed_chanstate(init_chanstate(C),
                                          np.full(C, 900), 0), C, device=card)
    feed = torch.full((T, C), 900, dtype=torch.int32, device=card)
    with slots_ab.slot_word_carry():
        with pytest.raises(ValueError, match="SLOT_WORD_CARRY"):
            tpg.process_window(feed, state, cfg, tc=1024, k_slots=1000,
                               time_packed=False)
        # the same k at a tc whose chunks can close fewer hits fits
        got = tpg.process_window(feed, state, cfg, tc=256, k_slots=1000,
                                 time_packed=False)
    want = tpg.process_window(feed, state, cfg, tc=256, k_slots=1000,
                              time_packed=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ilp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("blocks,threads", [(20, 128), (3, 40)])
def test_issue_probe_matches_plain(card, ilp, blocks, threads):
    """P1 at the TPG kernels' geometry and at an odd one (no whole warp)."""
    x = roofline.chains_input(ilp, blocks * threads, card)
    before = probes.launches["P1"]
    got = roofline.issue_chains(x, 7, blocks, threads)
    assert probes.launches["P1"] == before + 1
    assert torch.equal(got, roofline.issue_plain(x, 7))


def test_issue_probe_arms_are_checked_before_timing(card):
    """``probe_arms`` holds every arm to the plain version at its own ilp
    and geometry (the saturating 264 x 1024 among them) and reports the
    error it measured."""
    before = probes.launches["P1"]
    out = roofline.probe_arms(card, iters=(2_000, 12_000), trials=3)
    assert set(out["arms"]) == {a[0] for a in roofline.ARMS}
    for name, arm in out["arms"].items():
        assert arm["max_abs_err"] == 0 and arm["plain_ms"] > 0, name
        assert arm["check_iters"] == roofline.CHECK_ITERS
    # per arm: the check, two warm-ups and three trials at two counts
    assert probes.launches["P1"] == before + 9 * len(roofline.ARMS)


@pytest.mark.parametrize("name", i16_ops.OP_NAMES)
def test_i16_op_matches_plain(card, name):
    """P2's one-op kernels, the script's inputs and a full-range draw."""
    for seed in (None, 5):
        a, b = i16_ops.op_inputs(name, card, seed)
        before = probes.launches["P2-ops"]
        got = i16_ops.one_op(name, a, b)
        assert probes.launches["P2-ops"] == before + 1
        assert torch.equal(got, i16_ops.op_plain(name, a, b)), seed


@pytest.mark.parametrize("arm", i16_ops.ARMS)
@pytest.mark.parametrize("blocks,per_block", [(20, 128), (3, 80)])
def test_i16_mix_matches_plain(card, arm, blocks, per_block):
    feeds = i16_ops.mix_inputs(blocks * per_block, card)
    before = probes.launches["P2-mix"]
    got = i16_ops.mix(feeds[arm], 100, arm, blocks)
    assert probes.launches["P2-mix"] == before + 1
    assert torch.equal(got, i16_ops.mix_plain(feeds[arm], 100, arm))


@pytest.mark.parametrize("C,T", [(2560, 512), (200, 200)])
def test_frugal_probe_matches_plain(card, C, T):
    """P3: every arm against its plain version, every packed arm equal to
    unpacked after un-biasing; T = 200 leaves a tail after the 16-tick
    groups, C = 200 a partly empty block."""
    inputs = swar_frugal.arm_inputs(swar_frugal.make_adcs(T, C, seed=C), card)
    before = dict(probes.launches)
    checked = swar_frugal.check_parity(inputs)
    assert probes.launches["P3-unpacked"] == before["P3-unpacked"] + 1
    assert probes.launches["P3-packed"] == before["P3-packed"] + 3
    assert {a: c["max_abs_err"] for a, c in checked.items()} == \
        {a: 0 for a in swar_frugal.ARMS}
    for arm in swar_frugal.ARMS[2:]:
        got = swar_frugal.frugal(*inputs[arm], arm)
        want = swar_frugal.packed_plain(*inputs[arm])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_entries_refuse_cpu_routes(card):
    """A kernel entry given tensors on two devices raises."""
    x = roofline.chains_input(1, 128, card)
    with pytest.raises(ValueError):
        roofline.issue_launch(probes.library(), x, 1, 2, 128)   # wrong n
    a, b = i16_ops.op_inputs("add", card)
    with pytest.raises(ValueError):
        i16_ops.one_op("add", a, b.cpu())


# ---- the detector slice: K2 at the PDS and TDE widths, the PDS device
# path, the TDE arm under "pallas" and the three-arm app

@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS[:len(CONFIGS)])
@pytest.mark.parametrize("C,T,tc,k", [(40, 3072, 512, 4),
                                      (64, 512, 512, 8),
                                      (64, 333, 333, 8),
                                      (62, 333, 333, 8)])
def test_k2_detector_widths_match_plain(card, cfg, C, T, tc, k):
    """K2 at 40 channels (the PDS app's 10 links: a block of 32 and one of
    8) and 64 (a TDE link; the 512-tick windows of ``run_model`` and the
    333-tick tail of a 5965-tick cycle; 62, a link with two channels
    missing), against its plain version."""
    adcs, rmf = tpg_stream(T, C, tc, k, seed=C + T)
    st = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C,
                        device=card)
    feed = torch.from_numpy(adcs).to(card)
    before = tpg.process_window.function_launches["K2"]
    got = tpg.process_window(feed, st, cfg, tc, k, time_packed=False)
    assert tpg.process_window.function_launches["K2"] == before + 1
    want = tpg.process_window_plain(feed.cpu(), st.cpu(), cfg, tc, k,
                                    time_packed=False)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[0][:, :, -1] != 0).sum()) > 0


def test_pds_app_on_card_matches_cpu(card):
    from fdreadoutlibs_tpu_torch.apps.pds_readout import (PDSReadoutApp,
                                                          make_batch as pds)
    rng = np.random.default_rng(5)
    batches = [pds(rng, 10, 4, 0x2000000 + b * 3072, signal_rate=0.5)[0]
               for b in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        for pipelined in (False, True):
            app = PDSReadoutApp(n_links=10, device=dev, pipelined=pipelined)
            fetched = []
            fetch = app._fetch_hits

            def recording_fetch(packed, fetch=fetch, fetched=fetched):
                fetched.append(fetch(packed))
                return fetched[-1]

            app._fetch_hits = recording_fetch
            tpg.reset_launches()
            for scs in batches:
                app.process_batch(scs.copy())
            app.flush()
            out[dev, pipelined] = (fetched, app.handler.buffer.snapshot(),
                                   dict(tpg.process_window.function_launches))
    want = out["cpu", False]
    assert sum(len(h) for h, _ in want[0]) > 0
    for key, got in out.items():
        for (ha, da), (hb, db) in zip(got[0], want[0]):
            np.testing.assert_array_equal(ha, hb)
            assert da == db
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2]["K2"] == (3 if key[0] == "cuda" else 0)


def test_daphne_stream_processor_on_card_matches_cpu(card):
    from fdreadoutlibs_tpu_torch.formats import daphne
    from fdreadoutlibs_tpu_torch.stream import DAPHNEStreamFrameProcessor
    rng = np.random.default_rng(6)
    sc = daphne.empty_superchunks(8, stream=True)
    adcs = (800 + rng.normal(0, 10, (8 * 768, 4))).astype(np.uint16)
    adcs[1000:1010, 2] += 600
    daphne.stream_set_adcs(daphne.superchunk_frames(sc, stream=True)
                           .reshape(-1, daphne.STREAM_FRAME_SIZE),
                           adcs.reshape(-1, 64, 4))
    daphne.fake_timestamps(sc, 40_000, offset=64, stream=True)
    out = {}
    for dev in ("cuda", "cpu"):
        sink = QueueSender()
        p = DAPHNEStreamFrameProcessor(tp_sink=sink, device=dev)
        p.conf({"enable_tpg": True, "tpg_threshold": 150,
                "tpg_backend": "pallas"})
        p.start()
        p.process(sc[:4].copy())
        p.process(sc[4:].copy())
        out[dev] = (np.concatenate(sink.drain()), p.current_state())
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    for key in out["cpu"][1]:
        np.testing.assert_array_equal(out["cuda"][1][key], out["cpu"][1][key])


def test_detector_app_on_card_matches_cpu(card, tmp_path):
    """The three-arm app (TPC on the fused feed, K4; PDS, K2; TDE under
    "pallas", K2) on the card against the same on the CPU: the merged
    TPSet stream and per-arm info; one fragment per arm."""
    from fdreadoutlibs_tpu_torch.apps.detector_readout import (
        PDS_SOURCE_BASE, TDE_SOURCE_BASE, DetectorReadoutApp, _pds_batch,
        _tde_cycle, _tpc_batch)
    from fdreadoutlibs_tpu_torch.tp.recorder import FragmentRecorder
    rng = np.random.default_rng(8)
    batches = []
    for b in range(2):
        batches.append((_tpc_batch(rng, 4, 8, b, 0x1000000 + b * 8 * 2048),
                        _pds_batch(rng, 2, 2, 0x2000000 + b * 1536)[0],
                        _tde_cycle(rng, 2, 0x3000000 + b * 190880, True)))
    out = {}
    for dev in ("cuda", "cpu"):
        app = DetectorReadoutApp(apa_links=4, pds_links=2, tde_links=2,
                                 tde_backend="pallas", device=dev,
                                 fused_unpack=True)
        tpg.reset_launches()
        sets = []
        for tpc, pds, tde_frames in batches:
            app.process_tpc_batch(tpc.copy())
            app.process_pds_batch(pds.copy())
            app.process_tde_batch(tde_frames.copy())
            sets += app.drain_tpsets()
        app.flush()
        sets += app.drain_tpsets()
        rec = FragmentRecorder(tmp_path / dev)
        for sid in (1, PDS_SOURCE_BASE, TDE_SOURCE_BASE + 1):
            app.record_fragment(sid, 0, 1 << 30, rec)
        info = app.get_info()
        for arm in info.values():
            arm.pop("handler")
        out[dev] = (sets, info, [(tmp_path / dev / m["file"]).read_bytes()
                                 for m in rec.index()],
                    dict(tpg.process_window.function_launches))
    (sa, ia, fa, la), (sb, ib, fb, lb) = out["cuda"], out["cpu"]
    assert ia == ib and fa == fb and len(sa) == len(sb) > 0
    for x, y in zip(sa, sb):
        assert (x.origin, x.start_time, x.seqno) == \
            (y.origin, y.start_time, y.seqno)
        np.testing.assert_array_equal(x.objects, y.objects)
    # K4: one per TPC batch; K2: one per PDS batch + 12 windows per TDE
    # link per cycle
    assert la["K4"] == 2 and la["K2"] == 2 + 2 * 2 * 12
    assert not any(lb.values())


# ---- the modules slice: scheduler, entry(), CLI, checkpoint/resume ---------

def test_scheduler_on_card_matches_ingest_and_plain(card):
    """4 APAs x 4 links, interleaved in a seeded order: each APA equals a
    single-APA ``StreamingIngest`` on the card of its own batches, and the
    whole run equals the scheduler on the CPU (K2's plain version)."""
    from fdreadoutlibs_tpu_torch.apps.scheduler import MultiAPAScheduler
    L, N, n_apas = 4, 4, 4
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    rmf = np.where(np.arange(L * 64) % 2, cfg.rs_memory_factor_x10, 0)
    rng = np.random.default_rng(13)
    order = [int(a) for a in np.concatenate(
        [rng.permutation(n_apas) for _ in range(3)])]
    frames = [make_batch(rng, L, N, b, 0x1000000 + 8192 * b)[0]
              for b in range(len(order))]
    got = {}
    for dev in ("cuda", "cpu"):
        sched = MultiAPAScheduler(cfg, n_apas=n_apas, n_links=L, k_slots=4,
                                  rs_memory_factor=rmf, device=dev)
        tpg.reset_launches()
        outs = [sched.submit(a, f) for a, f in zip(order, frames)]
        outs.append(sched.flush())
        got[dev] = (outs, dict(tpg.process_window.function_launches),
                    [s.cpu() for s in sched._stacks])
    (outs, launches, stacks), (couts, claunches, cstacks) = \
        got["cuda"], got["cpu"]
    assert launches["K2"] == len(order) and not any(claunches.values())
    for o, c in zip(outs[:-1], couts[:-1]):
        assert (o is None) == (c is None)
        if o is not None:
            np.testing.assert_array_equal(o[0], c[0])
            assert o[1] == c[1]
    assert outs[-1].keys() == couts[-1].keys()
    for s, c in zip(stacks, cstacks):
        assert torch.equal(s, c)
    for apa in range(n_apas):
        ing = StreamingIngest(cfg, L, k_slots=4, device_compact=True,
                              max_hits=2048, rs_memory_factor=rmf,
                              device="cuda")
        mine = [f for a, f in zip(order, frames) if a == apa]
        want = [ing.submit(f) for f in mine][1:] + [ing.flush()]
        have = [o for a, o in zip(order, outs) if a == apa][1:] + \
            [outs[-1][apa]]
        assert sum(len(h) for h, _ in want) > 0
        for (h, d), (wh, wd) in zip(have, want):
            np.testing.assert_array_equal(h, wh)
            assert d == wd


def test_entry_on_card_matches_cpu(card):
    from fdreadoutlibs_tpu_torch.entry import entry
    tpg.reset_launches()
    fn, args = entry()
    assert args[0].is_cuda and args[1].is_cuda
    hits, n, state = fn(*args)
    assert tpg.process_window.function_launches["K4"] == 1
    fn_c, args_c = entry(device="cpu")
    hits_c, n_c, state_c = fn_c(*args_c)
    assert int(n) == int(n_c) == 1
    assert torch.equal(hits.cpu(), hits_c) and torch.equal(state.cpu(),
                                                            state_c)


def _cli(argv):
    import contextlib
    import io
    from fdreadoutlibs_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_tpg_emulator_and_compare_backends_on_card(card, tmp_path):
    z, g = str(tmp_path / "z.bin"), str(tmp_path / "g.bin")
    assert _cli(["make-zeros", "-o", z, "-n", "2"])[0] == 0
    assert _cli(["pattern-generator", "-f", z, "-p", "golden",
                 "--output", g])[0] == 0
    tpg.reset_launches()
    rc, out = _cli(["tpg-emulator", "-f", g, "-i", "pallas",
                    "--save-trigprim", str(tmp_path / "tps.txt")])
    assert rc == 0 and json.loads(out[-1])["hits"] == 2
    assert tpg.process_window.function_launches["K2"] == 1
    rc, out = _cli(["tpg-emulator", "-f", g, "-i", "reference",
                    "--save-trigprim", str(tmp_path / "ref.txt")])
    assert (tmp_path / "tps.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()
    frames, _ = make_batch(np.random.default_rng(3), 1, 16, 0, 0x1000000)
    frames[0].tofile(tmp_path / "noisy.bin")
    rc, out = _cli(["compare-backends", "-f", str(tmp_path / "noisy.bin"),
                    "-b", "reference", "scan", "pallas"])
    assert rc == 0 and out[-1].endswith("MATCH"), out


@pytest.mark.parametrize("alg,extra", [("AbsRS", []), ("FIR", ["-t", "5"]),
                                       ("FIR", ["-t", "5", "--fir-twopass",
                                                "2"])],
                         ids=["K2", "K3", "K5"])
def test_cli_profile_trace_names_the_kernel(card, tmp_path, alg, extra):
    tpg.reset_launches()
    rc, out = _cli(["profile", "-a", alg, "--channels", "256", "--ticks",
                    "1024", "--windows", "2", "-o", str(tmp_path / "tr"),
                    "--top", "20"] + extra)
    assert rc == 0
    assert json.loads(out[0])["backend"] == torch.cuda.get_device_name(0)
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert any("pipe_kernel" in ln for ln in out[1:]), out
    kern = {"AbsRS": "K2", "FIR": "K5" if extra[2:] else "K3"}[alg]
    retakes = [ln for ln in out[1:] if ln.startswith("# capture ")]
    assert tpg.process_window.function_launches[kern] == \
        1 + 2 * (1 + len(retakes))


def test_successive_profiles_record_every_launch(card, tmp_path):
    """Profiles after the first in a process leave a trace with a device
    record for every kernel launch and copy, at one APA's size, as
    ``chip_smoke.py`` profiles them (CUPTI is not torn down between
    captures, and a capture delivered short is taken again)."""
    from fdreadoutlibs_tpu_torch.utils.logging import (device_records,
                                                       trace_counts)
    for i in range(9):
        alg, extra = [("AbsRS", []), ("FIR", ["-t", "5"]),
                      ("FIR", ["-t", "5", "--fir-twopass", "2"])][i % 3]
        rc, _ = _cli(["profile", "-a", alg, "--channels", "2560", "--ticks",
                      "8192", "--windows", "4", "-o", str(tmp_path / f"{i}")]
                     + extra)
        assert rc == 0
        rec = device_records(str(tmp_path / f"{i}"))
        assert (rec["kernel"], rec["gpu_memcpy"]) == \
            (rec["launched"], rec["copied"]), (i, rec)
        assert sum(n for name, n in trace_counts(str(tmp_path / f"{i}"))[1]
                   .items() if "pipe_kernel" in name) == 4, i


def test_checkpoint_resume_with_state_on_card(card, tmp_path):
    from fdreadoutlibs_tpu_torch.ops import patterns
    from fdreadoutlibs_tpu_torch.stream import WIBEthFrameProcessor
    from fdreadoutlibs_tpu_torch.utils import checkpoint
    frames, _ = patterns.pattern_frames(
        "golden", first_timestamp=10_000, crate_id=1, slot_id=2,
        stream_id=3, n_frames=4, channel=7, offset=60)

    def make(dev):
        p = WIBEthFrameProcessor(tp_sink=QueueSender(), device=dev)
        p.conf({"crate_id": 1, "slot_id": 2, "link_id": 3,
                "enable_tpg": True, "tpg_threshold": 499,
                "tp_timeout": 100_000, "tpg_backend": "pallas"})
        p.start()
        return p

    cont = make("cpu")
    cont.process(frames.copy())
    want = np.concatenate(cont.tp_sink.drain())
    p1 = make("cuda")
    p1.process(frames[:2].copy())
    assert p1._dev_state.is_cuda and p1._state_stale
    ckpt = checkpoint.checkpoint_processor(p1, tmp_path / "c.npz")
    part1 = p1.tp_sink.drain()
    p2 = make("cuda")
    checkpoint.restore_processor(p2, ckpt)
    assert p2._dev_state is None and not p2._state_stale
    p2.process(frames[2:].copy())
    assert p2._dev_state.is_cuda
    got = np.concatenate(part1 + p2.tp_sink.drain())
    assert len(want) == 3
    np.testing.assert_array_equal(got, want)


# ---- the parallel slice: link-axis sharding on the card --------------------

def _pipeline_words(n_links: int, n_batches: int, seed: int) -> list:
    """Batches of (L, T, 28) uint32 frame words of 16 frames a link."""
    from fdreadoutlibs_tpu_torch.formats import wibeth
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        frames = make_batch(rng, n_links, 16, b, 0x1000000 + 32768 * b,
                            signal_rate=0.5)[0]
        out.append(wibeth.frames_bytes_to_u32(frames.reshape(
            -1, wibeth.FRAME_SIZE)).reshape(n_links, -1, 28))
    return out


def _pipeline_steps(pipe, batches) -> list:
    outs = []
    for w in batches:
        hits, n_hits, total = pipe.process(w)
        outs.append((np.asarray(hits), np.asarray(n_hits), total,
                     pipe.dropped_hits))
    outs.append({k: np.asarray(v) for k, v in pipe.state.items()})
    return outs


def _assert_steps_equal(got, want):
    for g, w in zip(got[:-1], want[:-1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[-1].keys() == want[-1].keys()
    for k in want[-1]:
        np.testing.assert_array_equal(got[-1][k], want[-1][k], err_msg=k)


@pytest.mark.parametrize("flags,kern", [({}, "K2"),
                                        ({"fused_unpack": True}, "K4"),
                                        ({"time2_feed": True}, "K1")],
                         ids=["canonical", "fused", "time2"])
def test_pipeline_shards_on_card_match_one_shard_and_cpu(card, flags, kern):
    """8 links: 8 shards on one card (each on its own stream) equal 1
    shard on the card and 2 shards on the CPU (the plain versions), two
    steps: hits, n_hits, totals, dropped and state; the 8-shard run
    launches the kernel once a shard a step."""
    from fdreadoutlibs_tpu_torch.parallel import APAPipeline, make_link_mesh
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    batches = _pipeline_words(8, 2, seed=41)
    got = {}
    for dev, n in (("cuda", 8), ("cuda", 1), ("cpu", 2)):
        pipe = APAPipeline(8, cfg, mesh=make_link_mesh(n, device=dev),
                           backend="pallas", **flags)
        tpg.reset_launches()
        got[(dev, n)] = _pipeline_steps(pipe, batches)
        launched = dict(tpg.process_window.function_launches)
        assert launched[kern] == (n * 2 if dev == "cuda" else 0)
        assert sum(launched.values()) == launched[kern]
    assert sum(o[2] for o in got[("cpu", 2)][:-1]) > 0
    _assert_steps_equal(got[("cuda", 8)], got[("cpu", 2)])
    _assert_steps_equal(got[("cuda", 1)], got[("cpu", 2)])


def test_detector_pipeline_on_card_matches_cpu(card):
    from fdreadoutlibs_tpu_torch.parallel import (DetectorPipeline,
                                                  make_apa_link_mesh)
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    words = [np.stack([w[:4], w[4:]]) for w in _pipeline_words(8, 2, 43)]
    got = {}
    for dev, n in (("cuda", 2), ("cpu", 1)):
        det = DetectorPipeline(2, 4, cfg, backend="pallas",
                               mesh=make_apa_link_mesh(2, n, device=dev))
        outs = []
        for w in words:
            hits, n_hits, totals = det.process(w)
            np.testing.assert_array_equal(totals,
                                          np.asarray(n_hits).sum(axis=1))
            outs.append((np.asarray(hits), np.asarray(n_hits), totals,
                         det.dropped_hits.copy()))
        outs.append({k: np.asarray(v) for k, v in det.state.items()})
        got[dev] = outs
    _assert_steps_equal(got["cuda"], got["cpu"])


def test_sharded_resume_on_card(card, tmp_path):
    """An 8-shard state on the card checkpointed after batch 1 restores
    into a fresh 1-shard pipeline on the card and a 2-shard one on the CPU:
    batch 2 and the state equal the uninterrupted run."""
    from fdreadoutlibs_tpu_torch.parallel import APAPipeline, make_link_mesh
    from fdreadoutlibs_tpu_torch.utils.checkpoint import (
        load_sharded_state, save_sharded_state)
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    batches = _pipeline_words(8, 3, seed=47)
    cont = APAPipeline(8, cfg, mesh=make_link_mesh(8, device="cuda"),
                       backend="pallas", time2_feed=True)
    _pipeline_steps(cont, batches[:2])
    save_sharded_state(tmp_path / "ckpt", cont.state)
    before = cont.dropped_hits
    want = _pipeline_steps(cont, batches[2:])
    for dev, n in (("cuda", 1), ("cpu", 2)):
        p = APAPipeline(8, cfg, mesh=make_link_mesh(n, device=dev),
                        backend="pallas", time2_feed=True)
        p.init_state(np.zeros((8, 64), np.int32))
        p.state = load_sharded_state(tmp_path / "ckpt", p.state)
        assert all(t.device.type == dev for v in p.state.values()
                   for t in v.shards.flat)
        p.dropped_hits = before
        _assert_steps_equal(_pipeline_steps(p, batches[2:]), want)


def test_dryrun_multichip_on_card_matches_cpu(card, capsys):
    from fdreadoutlibs_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2)
    on_card = capsys.readouterr().out.strip().splitlines()[-1]
    dryrun_multichip(2, device="cpu")
    on_cpu = capsys.readouterr().out.strip().splitlines()[-1]
    assert on_card.startswith("dryrun_multichip OK") and on_card == on_cpu


def test_kernel_leaves_the_callers_device(card):
    """A launch on another card leaves the calling thread's current device
    as it was (the C entries restore it, ``csrc/device_scope.cuh``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: a launch on a card other than the "
                    "current one")
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    adcs, rmf = tpg_stream(256, 64, 64, 2, seed=5)
    state = tpg.pack_state(seed_chanstate(init_chanstate(64), adcs[0], rmf),
                           64)
    torch.cuda.set_device(0)
    other = torch.device("cuda", 1)
    got = tpg.process_window(torch.from_numpy(adcs).to(other),
                             state.to(other), cfg, 64, 2, time_packed=False)
    assert torch.cuda.current_device() == 0
    want = tpg.process_window_plain(torch.from_numpy(adcs), state, cfg, 64, 2,
                                    time_packed=False)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    x = roofline.chains_input(1, 128, other)
    roofline.issue_chains(x, 3, 1, 128)
    assert torch.cuda.current_device() == 0


# ---- the tool slice: the geometry, the tuner and the fuzzers on the card ---

_GEOMETRY = Geometry(16, 64, 4)       # chip_smoke.py phase 12's


@pytest.mark.parametrize("name,cfg,time2,twopass,packed", [
    ("K1-AbsRS", TPGConfig.from_raw("AbsRS", threshold=150), True, 0, None),
    ("K2-Simple", CONFIGS[1], False, 0, None),
    ("K3-FIR", _FIR, False, 0, None),
    ("K5-FIR-lift", dataclasses.replace(_FIR, track_peaks=False), True, 2,
     None),
    ("K4-AbsRS-frames", CONFIGS[2], False, 0, "frames"),
])
def test_geometry_library_matches_shipped_and_plain(card, name, cfg, time2,
                                                    twopass, packed):
    """The tpg library of a non-shipped geometry (stages of 64 ticks) on
    the card, chunks of 96 ticks (a stage of 64 and a ragged one of 32),
    two windows carrying state: slots, nclose and state equal the shipped
    library's and the plain version's, bit for bit."""
    C, T, tc, k = 256, 1152, 96, 2
    fir = cfg.algorithm == Algorithm.FIR
    adcs, rmf = (fir_stream(2 * T, C, tc, k, 5), 0) if fir else \
        tpg_stream(2 * T, C, tc, k, seed=5)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C)
    states = {"plain": state, "shipped": state.to(card),
              "geometry": state.to(card)}
    closes = 0
    for w in range(2):
        win = adcs[w * T:(w + 1) * T]
        feed = torch.from_numpy(
            frame_words(win).view(np.int32) if packed else
            time2_words(win) if time2
            else win)
        kw = dict(time_packed=time2, packed14=packed, fir_twopass=twopass)
        outs = {}
        for arm, geometry in (("plain", None), ("shipped", None),
                              ("geometry", _GEOMETRY)):
            dev = "cpu" if arm == "plain" else card
            outs[arm] = tpg.process_window(feed.to(dev), states[arm], cfg,
                                           tc, k, geometry=geometry, **kw)
            states[arm] = outs[arm][2]
        for arm in ("shipped", "geometry"):
            for got, want in zip(outs[arm], outs["plain"]):
                assert torch.equal(got.cpu(), want), (name, w, arm)
        closes = max(closes, int(outs["plain"][1].max()))
    assert closes > k                       # drops exercised


def test_autotune_quick_on_card(card, tmp_path):
    """The tuner on the card, small: every candidate equals the plain
    version at its tc and k and the geometry the shipped library; the
    written file reads back through ``kernel_knobs``."""
    from fdreadoutlibs_tpu_torch.probes import autotune
    from fdreadoutlibs_tpu_torch.utils import tuning
    res = autotune.run(card, algs=["AbsRS", "FIR"], quick=True,
                       geometries=[_GEOMETRY], C=256, T=2048, windows=2,
                       trials=2, confirm=2, confirm_trials=2,
                       log=lambda line: None)
    assert all(r["ms"] > 0 for rows in res["sweep"].values() for r in rows)
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps(res["tuned"]))
    for alg, entry in res["tuned"].items():
        knobs = tuning.kernel_knobs(TPGConfig.from_raw(alg, threshold=5),
                                    path=str(path))
        assert (knobs["tc"], knobs["k_slots"]) == (entry["tc"], entry["k"])
        assert tuple(knobs["geometry"]) == tuple(
            entry[f] for f in Geometry._fields)


def test_fuzz_sweep_on_card(card):
    """Random configurations, uneven batches: the kernels (K2, K3; K1 and
    K5 on every case here) equal their plain version and the oracle."""
    from fdreadoutlibs_tpu_torch.probes import fuzz_sweep
    res = fuzz_sweep.sweep(8, 30_000, card, kernel_every=1)
    assert res["failures"] == 0 and res["launches"] > 0


def test_fuzz_frames_on_card(card):
    """Corrupt payloads through every rig's "pallas" backend on the card:
    nothing escapes, the seq/ts errors are seen, the TPs equal the plain
    version's and the reference's under the kernel's contract."""
    from fdreadoutlibs_tpu_torch.probes import fuzz_frames
    res = fuzz_frames.sweep(0, 60_000, card, per_rig=1)
    assert res["failures"] == 0 and res["launches"]


def test_bench_kernel_cells_report_parity(card):
    """The bench's kernel cells at 2560 x 8192 with one trial: every
    family's first window and every production variant's equal the plain
    version on the card, and each reads a positive RTF."""
    from fdreadoutlibs_tpu_torch import bench
    adcs = bench.make_adcs(bench.T_CARD, bench.C_APA)
    plain = None
    for name, cfg in bench.configs().items():
        knobs = tuning.kernel_knobs(cfg)
        rmf = bench.mixed_rmf(cfg, bench.C_APA) \
            if name == "AbsRS_production" else cfg.rs_memory_factor_x10
        res = bench.bench_algorithm(cfg, knobs["tc"], knobs["k_slots"], adcs,
                                    rmf, 2, 1, knobs["fir_twopass"],
                                    knobs["geometry"], card)
        assert res["rtf"] > 0 and res["plain"] is not None, name
        if name == "AbsRS_production":
            plain, prod, prod_knobs, prod_rmf = res["plain"], cfg, knobs, rmf
    out, parity = bench.bench_fresh_and_ingest(
        prod, prod_knobs["tc"], prod_knobs["k_slots"], adcs, prod_rmf, 2, 1,
        geometry=prod_knobs["geometry"], device=card, plain=plain)
    assert parity == {v: True for v in bench.VARIANTS}, out
    assert all(out[v] > 0 for v in bench.VARIANTS), out


def test_bench_failing_cell_exits_nonzero(card, monkeypatch, capsys):
    """On the card a cell that raises leaves its ``*_error`` key in the line
    and the bench exits 1 (the headline at 256 channels x 1024 ticks: the
    exit code is the point)."""
    from fdreadoutlibs_tpu_torch import bench
    from fdreadoutlibs_tpu_torch.bench import app_rtf

    def boom(*args, **kw):
        raise RuntimeError("cell failed")
    monkeypatch.setattr(bench, "C_APA", 256)
    monkeypatch.setattr(bench, "T_CARD", 1024)
    monkeypatch.setattr(app_rtf, "bench_app_rtf", boom)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cell failed" in line["app_rtf_error"]
    assert line["parity"] is True and "frontends" in line


def test_slab_at_a_tuned_group_that_does_not_divide_tc(card):
    """The slab at a tuned geometry of group 32 with tc = 48 launches the
    shipped library with a warning: the hits, nclose and state of
    ``geometry=None``."""
    from fdreadoutlibs_tpu_torch.ops.ingest import process_words14_feed
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    C, T, tc = 128, 144, 48
    adcs, rmf = tpg_stream(T, C, tc, 2, seed=31)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, device=card)
    feed = pack_words14(torch.from_numpy(frame_words(adcs).view(np.int32))
                        .to(card))
    with pytest.warns(UserWarning, match="shipped geometry"):
        got = process_words14_feed(feed, state, cfg, C, tc=tc, k_slots=2,
                                   slab=True, geometry=Geometry(32, 32, 4))
    want = process_words14_feed(feed, state, cfg, C, tc=tc, k_slots=2,
                                slab=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((want[0][:, :, -1] != 0).sum()) > 0
