"""The port's APAReadoutApp (device="cpu": the kernel's plain version)
against the JAX package's (Pallas interpret mode), on the production
configuration (AbsRS, threshold-on-collection) with each of its four feeds:
time2, fused in-kernel unpack, words14 and the plain packed feed.  Hits,
counters, dropped counts, the TP latency buffer and the TPSets must be
equal."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.apps.apa_readout import APAReadoutApp as JaxApp
from fdreadoutlibs_tpu_torch.apps.apa_readout import (APAReadoutApp,
                                                      make_batch)
from fdreadoutlibs_tpu_torch.formats import wibeth

torch.set_num_threads(1)

L, N, BATCHES = 3, 4, 3
PROD = dict(algorithm="AbsRS", threshold=150, threshold_on_collection=True,
            time2_feed=True)
TIMING_KEYS = ("rate_tp_hits_khz", "interval_seconds")


def run(app, batches):
    """Drive `app` over `batches`, recording each fetched hit array."""
    fetched = []
    fetch = app._fetch_hits

    def recording_fetch(packed):
        hits, dropped = fetch(packed)
        fetched.append((hits, dropped))
        return hits, dropped

    app._fetch_hits = recording_fetch
    for frames in batches:
        app.process_batch(frames.copy())
    app.flush()
    info = app.get_info()
    info["handler"] = {k: v for k, v in info["handler"].items()
                       if k not in TIMING_KEYS}
    # the port's own counter (the JAX app has none); its tests are below
    info.pop("words_copy_bytes", None)
    return fetched, info, app.handler.buffer.snapshot(), app.tpset_q.drain()


def make_batches(seed, n_batches=BATCHES, n_links=L, n_frames=N):
    rng = np.random.default_rng(seed)
    ts, out = 0x1000000, []
    for b in range(n_batches):
        frames, _ = make_batch(rng, n_links, n_frames, b, ts, signal_rate=0.5)
        out.append(frames)
        ts += n_frames * 2048
    return out


def assert_same_run(a, b):
    (fa, ia, ta, sa), (fb, ib, tb, sb) = a, b
    assert len(fa) == len(fb) == BATCHES
    for (ha, da), (hb, db) in zip(fa, fb):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    assert ia == ib
    np.testing.assert_array_equal(ta, tb)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert (x.run_number, x.type, x.origin, x.start_time, x.end_time,
                x.seqno) == (y.run_number, y.type, y.origin, y.start_time,
                             y.end_time, y.seqno)
        np.testing.assert_array_equal(x.objects, y.objects)


def test_port_app_matches_jax_app():
    batches = make_batches(seed=21)
    port = run(APAReadoutApp(n_links=L, device="cpu", **PROD), batches)
    ref = run(JaxApp(n_links=L, pallas_interpret=True, **PROD), batches)
    assert_same_run(port, ref)
    info = port[1]
    assert info["total_hits"] > 0 and info["total_tps_sent"] > 0
    assert info["ts_errors"] == 0
    assert len(port[3]) > 0                      # TPSets were emitted


@pytest.mark.parametrize("per_link", [False, True],
                         ids=["batched", "per-link-assembly"])
def test_pipelined_matches_sync(per_link):
    """Depth-2 pipelining changes when work happens, never what comes out
    (same fetched hits, counters, TPs and TPSets after flush)."""
    batches = make_batches(seed=23)
    kw = dict(n_links=L, device="cpu", batched_assembly=not per_link, **PROD)
    assert_same_run(run(APAReadoutApp(pipelined=True, **kw), batches),
                    run(APAReadoutApp(**kw), batches))


def test_apa_readout_end_to_end_time2():
    """Port copy of tests/test_apps.py::test_apa_readout_end_to_end's time2
    case: one golden-like hill on link 1, channel 7 in the second batch."""
    app = APAReadoutApp(n_links=2, threshold=499, time2_feed=True,
                        device="cpu")
    ts = 100_000
    for b in range(3):
        frames = np.zeros((2, 1, wibeth.FRAME_SIZE), np.uint8)
        adcs = np.full((2, 1, 64, 64), 800, np.uint16)
        if b == 1:
            adcs[1, 0, 10:19, 7] += np.array(
                [500, 502, 504, 505, 506, 505, 504, 502, 500], np.uint16)
        for l in range(2):
            wibeth.set_adcs(frames[l], adcs[l])
            wibeth.fake_timestamps(frames[l], ts)
            wibeth.fake_seq_ids(frames[l], b)
            wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
        app.process_batch(frames)
        ts += 2048
    info = app.get_info()
    assert info["total_hits"] == 1
    assert info["total_tps_sent"] == 1
    assert info["ts_errors"] == 0
    assert info["raw_buffered"] == 6
    raw = app.request_raw(1, 100_000 + 2048, 100_000 + 2 * 2048)
    assert len(raw) >= 1
    tps = app.handler.buffer.snapshot()
    assert len(tps) == 1
    assert tps["time_start"][0] == 100_000 + 2048 + 32 * 10


def test_latency_info_and_cli(capsys):
    from fdreadoutlibs_tpu_torch.apps.apa_readout import main
    app = APAReadoutApp(n_links=2, device="cpu", **PROD)
    for frames in make_batches(seed=3, n_batches=2, n_links=2):
        app.process_batch(frames)
    lat = app.latency_info(frames_per_batch=N)
    assert lat["batches"] == 2 and lat["min_latency_ticks"] > 0
    assert set(lat["stages_ms_p50"]) == {
        "preprocess_ms", "retention_ms", "words_ms", "codec_ms",
        "h2d_host_ms", "tpg_launch_ms", "compact_launch_ms", "fetch_ms",
        "assembly_ms", "handler_ms"}
    assert main(["--links", "2", "--frames-per-batch", "2", "--batches",
                 "2", "--time2-feed", "--algorithm", "AbsRS",
                 "--threshold-on-collection", "--device", "cpu"]) == 0
    assert '"ts_errors": 0' in capsys.readouterr().out


def test_chip_smoke_oracle_matches_jax_app():
    """chip_smoke.py holds the app on the card against the kernel's plain
    version with the app's seeding, chunking and compaction; here that
    oracle is held against the JAX app's fetched hits on the same frames."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(29)
    frames, adcs = [], []
    for b in range(2):
        f, a = make_batch(rng, L, N, b, 0x1000000 + b * N * 2048,
                          signal_rate=0.5)
        frames.append(f)
        adcs.append((a & 0x3FFF).transpose(1, 2, 0, 3)
                    .reshape(N * 64, L * 64).astype(np.int32))
    jax_app = JaxApp(n_links=L, pallas_interpret=True, **PROD)
    fetched = run(jax_app, frames)[0]
    rmf = np.concatenate([p.register_memory_factor for p in jax_app.procs])
    got = list(smoke.plain_app_hits(adcs, rmf, jax_app.cfg, jax_app.k_slots,
                                    "cpu"))
    assert len(got) == len(fetched) == 2
    for (ha, da), (hb, db) in zip(got, fetched):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    assert sum(len(h) for h, _ in got) > 0


FEEDS = {"fused": dict(fused_unpack=True), "words14": dict(words14_feed=True),
         "packed": {}}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_port_app_feed_matches_jax_app(feed):
    """The packed-word feeds (K4 fused / words14, K2 packed) against the
    JAX app with the same feed flag, on the same frames."""
    kw = dict(PROD, time2_feed=False, **FEEDS[feed])
    batches = make_batches(seed=31)
    port = run(APAReadoutApp(n_links=L, device="cpu", **kw), batches)
    ref = run(JaxApp(n_links=L, pallas_interpret=True, **kw), batches)
    assert_same_run(port, ref)
    info = port[1]
    assert info["total_hits"] > 0 and info["total_tps_sent"] > 0
    assert info["ts_errors"] == 0
    assert len(port[3]) > 0


def test_feeds_agree_and_flags_exclusive():
    """Same frames, same function: every feed fetches the same hits; the
    JAX app's exclusivity rules hold."""
    batches = make_batches(seed=37, n_batches=2, n_links=2)
    runs = [run(APAReadoutApp(n_links=2, device="cpu",
                              **{**PROD, "time2_feed": False, **kw}),
                batches)[0]
            for kw in ({"time2_feed": True}, *FEEDS.values())]
    for other in runs[1:]:
        for (ha, da), (hb, db) in zip(runs[0], other):
            np.testing.assert_array_equal(ha, hb)
            assert da == db
    for bad in (dict(words14_feed=True, time2_feed=True),
                dict(fused_unpack=True, time2_feed=True)):
        with pytest.raises(ValueError, match="exclusive"):
            APAReadoutApp(n_links=1, device="cpu", **bad)


def test_time2_app_makes_no_words_copy(monkeypatch):
    """The time2 feed's codec reads the frames in place: with the words
    copy made impossible the app still fetches the JAX app's hits and
    emits its TPSets, and counts no bytes copied into a words page."""
    batches = make_batches(seed=41)
    ref = run(JaxApp(n_links=L, pallas_interpret=True, **PROD), batches)

    def no_copy(*args, **kwargs):
        raise AssertionError("the time2 feed copied the frames' words")

    monkeypatch.setattr(wibeth, "frames_bytes_to_u32", no_copy)
    app = APAReadoutApp(n_links=L, device="cpu", pipelined=True, **PROD)
    assert_same_run(run(app, batches), ref)
    assert app.get_info()["words_copy_bytes"] == 0


@pytest.mark.parametrize("feed", list(FEEDS))
def test_packed_word_feeds_count_their_words_copy(feed):
    """Every other feed ships or relays the words, so it copies them: L x
    N x 7168 bytes a batch."""
    app = APAReadoutApp(n_links=L, device="cpu",
                        **dict(PROD, time2_feed=False, **FEEDS[feed]))
    for b, frames in enumerate(make_batches(seed=43)):
        app.process_batch(frames)
        assert app.get_info()["words_copy_bytes"] == (b + 1) * L * N * 7168


def _unported(case):
    from fdreadoutlibs_tpu.ops import TPGConfig
    from fdreadoutlibs_tpu_torch.ops import ingest
    return ingest.StreamingIngest(TPGConfig(), n_links=1, format=case,
                                  device="cpu")


@pytest.mark.parametrize("case", ["daphne_stream"])
def test_unported_feeds_refused(case):
    """DAPHNE-stream, once the one feed the port refused, is ported
    (tests/test_torch_pds.py holds it to the JAX package); a format neither
    package has is refused."""
    assert _unported(case).n_channels == 4
    with pytest.raises(ValueError, match="unknown format"):
        _unported("daphne_selftriggered")
