"""The port's device unpack, packed ingest, hit collection and per-link
frame processors (WIBEth, WIB2) against the JAX package, on the CPU (the
kernel's plain version).  Inputs are made by numpy from a seed; integer
pipeline, exact equality.

tc: the JAX processors cap the chunk at 512 ticks in interpret mode and at
the knob's 256 in production, and dropped counts depend on tc.  Every
processor batch here is at most 256 ticks, so both packages run tc = T and
drop the same hits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.formats import bitpack as jbitpack
from fdreadoutlibs_tpu.ops import TPGConfig, patterns
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.stream import WIB2FrameProcessor as JWIB2
from fdreadoutlibs_tpu.stream import WIBEthFrameProcessor as JWIBEth
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu_torch.formats import bitpack, wib2, wibeth
from fdreadoutlibs_tpu_torch.ops import ingest, tpg
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor, \
    WIBEthFrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import tpg_stream, wib2_superchunks

torch.set_num_threads(1)

FIR = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)


# ---- (c) the device unpack -------------------------------------------------

@pytest.mark.parametrize("n_words,n_channels", [(28, 64), (112, 256)],
                         ids=["wibeth", "wib2"])
def test_torch_unpack_matches_numpy_and_jnp(n_words, n_channels):
    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 1 << 32, size=(3, 5, n_words), dtype=np.uint64) \
        .astype(np.uint32)             # every bit pattern, sign bits too
    got = bitpack.unpack_14bit_torch(torch.from_numpy(words.view(np.int32)),
                                     n_channels)
    assert got.dtype == torch.int32 and got.shape == (3, 5, n_channels)
    np.testing.assert_array_equal(got.numpy(),
                                  jbitpack.unpack_14bit(words, n_channels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jbitpack.unpack_14bit_jnp(jnp.asarray(words), n_channels)))
    fmt = wibeth if n_channels == 64 else wib2
    np.testing.assert_array_equal(
        fmt.unpack_frames(torch.from_numpy(words)).numpy(), got.numpy())


def test_torch_unpack_refuses_partial_groups():
    with pytest.raises(ValueError):
        bitpack.unpack_14bit_torch(torch.zeros((2, 28), dtype=torch.int32),
                                   60)
    with pytest.raises(ValueError):
        bitpack.unpack_14bit_torch(torch.zeros((2, 27), dtype=torch.int32),
                                   64)


# ---- (d) packed ingest + hit collection ------------------------------------

def _wib2_words(L, N, seed):
    """(L, 12N, 112) packed words and their (12N, 256L) ADCs; link 0
    channel 5 closes 4 hits in the first 64 ticks (drops at K=2)."""
    sc, adcs = wib2_superchunks(L, N, seed)
    for j in range(4):
        adcs[0, 2 + 14 * j:4 + 14 * j, 5] += 3000
    wib2.set_adcs(wib2.superchunk_frames(sc[0]),
                  adcs[0].reshape(N, wib2.FRAMES_PER_SUPERCHUNK, -1))
    frames = wib2.superchunk_frames(sc.reshape(-1, wib2.SUPERCHUNK_SIZE))
    words = np.ascontiguousarray(wib2.adc_region_u32(frames)) \
        .reshape(L, N * wib2.FRAMES_PER_SUPERCHUNK, wib2.ADC_WORDS)
    return words, adcs.transpose(1, 0, 2).reshape(-1, L * wib2.N_CHANNELS)


def _wibeth_words(L, N, seed, tc, k):
    T, C = N * 64, L * 64
    adcs, rmf = tpg_stream(T, C, tc, k, seed)
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), np.uint8)
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[:, l * 64:(l + 1) * 64]
                        .reshape(N, 64, 64).astype(np.uint16))
    words = wibeth.frames_bytes_to_u32(frames.reshape(-1, wibeth.FRAME_SIZE))
    return words.reshape(L, T, 28), adcs, rmf


@pytest.mark.parametrize("fmt", ["wib2", "wibeth"])
def test_packed_ingest_and_collect_hits_match_jax(fmt):
    """Two batches with the state carried: the port's packed ingest equals
    the JAX one (state), and its hits and dropped counts — device
    compaction and host decode — equal the JAX collect_hits' both ways."""
    tc, k = 64, 2
    if fmt == "wib2":
        words, adcs = _wib2_words(2, 16, seed=4)      # T = 192
        cfg, rmf = FIR, 0
        j_fn, p_fn = jingest.process_packed_wib2, ingest.process_packed_wib2
    else:
        words, adcs, rmf = _wibeth_words(3, 2, seed=4, tc=tc, k=k)
        cfg = TPGConfig.from_raw("AbsRS", threshold=150)
        j_fn, p_fn = jingest.process_packed_frames, \
            ingest.process_packed_frames
    C = adcs.shape[1]
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    stack, state = jtpg.pack_state(st, C), tpg.pack_state(st, C)
    dropped_total = 0
    for _ in range(2):
        js, jn, stack = j_fn(jnp.asarray(words), stack, cfg, C, tc=tc,
                             k_slots=k, unroll=1, interpret=True)
        ps, pn, state = p_fn(torch.from_numpy(words.view(np.int32)), state,
                             cfg, C, tc=tc, k_slots=k)
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
        for device in (True, False):
            want, d_want = jingest.collect_hits(js, jn, C, device=device)
            hits, d = ingest.collect_hits(ps, pn, C, device=device)
            np.testing.assert_array_equal(hits, want)
            assert d == d_want
        assert len(want) > 0
        dropped_total += d
    assert dropped_total > 0


def test_collect_hits_overflow_and_offset():
    """max_hits below the valid count: the device compaction keeps the
    first max_hits in canonical order and counts the rest as dropped;
    tick_offset shifts end ticks on both routes."""
    words, adcs = _wib2_words(1, 16, seed=9)
    C = adcs.shape[1]
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C)
    ps, pn, _ = ingest.process_packed_wib2(
        torch.from_numpy(words.view(np.int32)), state, FIR, C, tc=96,
        k_slots=8)
    full, d0 = ingest.collect_hits(ps, pn, C, device=False)
    assert d0 == 0 and len(full) > 4
    cut, d = ingest.collect_hits(ps, pn, C, max_hits=4)
    np.testing.assert_array_equal(cut, full[:4])
    assert d == len(full) - 4
    for device in (True, False):
        shifted, _ = ingest.collect_hits(ps, pn, C, tick_offset=500,
                                         device=device)
        np.testing.assert_array_equal(shifted["end_tick"],
                                      full["end_tick"] + 500)


# ---- (e) the processors against the JAX processors -------------------------

CONF = {"crate_id": 1, "slot_id": 0, "link_id": 3, "enable_tpg": True,
        "tp_timeout": 100_000, "tpg_k_slots": 2}


def _run(cls, sink, batches, **conf):
    p = cls(tp_sink=sink) if cls in (JWIB2, JWIBEth) else \
        cls(tp_sink=sink, device="cpu")
    p.conf(dict(CONF, **conf))
    p.start()
    for b in batches:
        p.process(b.copy())
    tps = sink.drain()
    counts = {k: p.metrics.count(k) for k in (
        "num_hits", "num_hits_dropped", "num_tps_sent", "num_ts_errors",
        "num_link_misconfigurations")}
    return (np.concatenate(tps) if tps else np.zeros(0)), counts, \
        p.current_state()


def _assert_same(port, jax_):
    (tps, counts, st), (j_tps, j_counts, j_st) = port, jax_
    assert len(j_tps) > 0
    np.testing.assert_array_equal(tps, j_tps)
    assert counts == j_counts
    for key in tpg._STATE_KEYS + ("fir_prev",):
        np.testing.assert_array_equal(st[key], np.asarray(j_st[key]),
                                      err_msg=key)


def _wib2_batches():
    """Two 96-tick batches of one link (geo-id 1/0/3); a pulse straddles
    the batch boundary at tick 96."""
    sc, adcs = wib2_superchunks(1, 16, seed=21)
    adcs = adcs[0]
    adcs[90:104, 77] += 2500
    wib2.set_adcs(wib2.superchunk_frames(sc[0]), adcs.reshape(16, 12, 256))
    wib2.fake_geoid(sc[0], 1, 0, 3)
    return [sc[0, :8], sc[0, 8:]]


@pytest.mark.parametrize("time2", [False, True], ids=["packed", "time2"])
@pytest.mark.parametrize("algorithm,threshold", [("FIR", 5),
                                                 ("SimpleThreshold", 120)])
def test_wib2_processor_matches_jax(algorithm, threshold, time2):
    batches = _wib2_batches()
    conf = {"tpg_algorithm": algorithm, "tpg_threshold": threshold,
            "tpg_time2_feed": time2}
    _assert_same(_run(WIB2FrameProcessor, QueueSender(), batches, **conf),
                 _run(JWIB2, JQueueSender(), batches, tpg_backend="pallas",
                      tpg_pallas_interpret=True, **conf))


def _wibeth_batches():
    """Two 128-tick batches of one link; a pulse straddles tick 128."""
    adcs, _ = tpg_stream(256, 64, 128, 2, seed=8)
    adcs[120:136, 40] += 2500
    frames = np.zeros((4, wibeth.FRAME_SIZE), np.uint8)
    wibeth.set_adcs(frames, adcs.reshape(4, 64, 64).astype(np.uint16))
    wibeth.fake_timestamps(frames, 0x100000)
    wibeth.fake_seq_ids(frames, 0)
    wibeth.fake_geoid(frames, 1, 0, 3)
    return [frames[:2], frames[2:]]


@pytest.mark.parametrize("time2", [False, True], ids=["packed", "time2"])
@pytest.mark.parametrize("algorithm,threshold", [("FIR", 5),
                                                 ("SimpleThreshold", 120)])
def test_wibeth_processor_matches_jax(algorithm, threshold, time2):
    batches = _wibeth_batches()
    conf = {"tpg_algorithm": algorithm, "tpg_threshold": threshold,
            "tpg_time2_feed": time2}
    _assert_same(_run(WIBEthFrameProcessor, QueueSender(), batches, **conf),
                 _run(JWIBEth, JQueueSender(), batches, tpg_backend="pallas",
                      tpg_pallas_interpret=True, **conf))


def test_processor_backends_and_device():
    with pytest.raises(ValueError):
        WIB2FrameProcessor(device="cpu").conf(dict(CONF, tpg_backend="scan"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            WIB2FrameProcessor(device="cuda")
    p = WIB2FrameProcessor(device="cpu")
    p.conf(dict(CONF, tpg_algorithm="FIR", tpg_track_peaks=True))
    assert p.tpg_cfg.track_peaks and p.backend == "pallas"


# ---- (f) the counters of tests/test_stream_others.py -----------------------

class TestWIB2Counters:
    def make(self, **conf):
        sink = QueueSender()
        proc = WIB2FrameProcessor(tp_sink=sink, device="cpu")
        c = {"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
             "tpg_algorithm": "SimpleThreshold", "tpg_threshold": 499,
             "tp_timeout": 100_000}
        c.update(conf)
        proc.conf(c)
        proc.start()
        return proc, sink

    def golden_superchunks(self, n=8, channel=100, ts0=100_000):
        T = n * wib2.FRAMES_PER_SUPERCHUNK
        adcs = np.zeros((T, 256), dtype=np.uint16)
        adcs[10:19, channel] = patterns.GOLDEN_ADCS
        sc = wib2.empty_superchunks(n)
        wib2.set_adcs(wib2.superchunk_frames(sc), adcs.reshape(n, 12, 256))
        wib2.fake_timestamps(sc, ts0)
        wib2.fake_geoid(sc, 1, 2, 3)
        return sc

    @pytest.mark.parametrize("time2", [False, True], ids=["packed", "time2"])
    def test_golden_tp_wib2_variant(self, time2):
        ts0 = 100_000
        proc, sink = self.make(tpg_time2_feed=time2)
        sc = self.golden_superchunks(ts0=ts0)
        proc.process(sc[:1])          # the hill (ticks 10-18) spans batches
        proc.process(sc[1:])
        tps = np.concatenate(sink.drain())
        assert len(tps) == 1
        tp = tps[0]
        t_begin = ts0 + 32 * (19 - 9)
        t_end = ts0 + 32 * 19
        assert tp["time_start"] == t_begin
        assert tp["time_peak"] == (t_begin + t_end) // 2
        assert tp["adc_integral"] == 4528
        assert tp["adc_peak"] == 4528 // 20
        assert proc.metrics.count("num_ts_errors") == 0

    def test_superchunk_ts_gap(self):
        proc, _ = self.make()
        sc = self.golden_superchunks()
        frames = wib2.superchunk_frames(sc)
        for i in (6, 7):
            wib2.set_timestamp(frames[i], wib2.get_timestamp(frames[i]) + 384)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 1

    def test_link_misconfiguration(self):
        proc, _ = self.make(crate_id=7)
        proc.process(self.golden_superchunks())
        assert proc.metrics.count("num_link_misconfigurations") == 1

    def test_emulator_mode(self):
        proc, _ = self.make(emulator_mode=True)
        sc = self.golden_superchunks()
        wib2.set_timestamp(wib2.superchunk_frames(sc).reshape(-1, 472),
                           np.arange(96, dtype=np.uint64) * 7)
        proc.process(sc)
        assert proc.metrics.count("num_ts_errors") == 0
