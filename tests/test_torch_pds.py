"""The port's PDS (DAPHNE) path against the JAX package's, on the CPU: the
DAPHNE self-triggered and stream formats and the device unpack, the
self-triggered pulse finder, ``DAPHNEStreamFrameProcessor`` under its three
backends, ``ingest.process_packed_daphne``, ``StreamingIngest(format=
"daphne_stream")`` in its modes, and ``PDSReadoutApp`` sync and pipelined.
The port runs on ``device="cpu"`` (the kernel's plain version), the JAX
package in Pallas interpret mode (its app's ingest entry routed there by
``test_torch_detector.jax_interpret``, as ``tests/conftest.py::
interpret_ingest`` routes it), on the same numpy-made bytes; hits, dropped counts, TPs,
TPSets and carried state bit-equal (tolerance 0, an integer pipeline).
The card's K2 at the PDS app's 40 channels runs here built for the host
(``tests/torch_host_lib.py``) under the app.

tc: the JAX stream processor caps the chunk at 512 ticks in interpret mode
and at the knob's in production; the SimpleThreshold knob is 512 too, so
both packages chunk (and drop) alike."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.apps.pds_readout import PDSReadoutApp as JaxPDS
from fdreadoutlibs_tpu.formats import daphne as jdaphne
from fdreadoutlibs_tpu.ops import TPGConfig
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.stream.daphne import \
    DAPHNEFrameProcessor as JSelfTrig
from fdreadoutlibs_tpu.stream.daphne import \
    DAPHNEStreamFrameProcessor as JStream
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueue
from fdreadoutlibs_tpu_torch import native
from fdreadoutlibs_tpu_torch.apps.pds_readout import PDSReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.formats import daphne
from fdreadoutlibs_tpu_torch.ops import ingest, tpg
from fdreadoutlibs_tpu_torch.stream import (DAPHNEFrameProcessor,
                                            DAPHNEStreamFrameProcessor)
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from test_torch_detector import assert_same_tpsets, jax_interpret
from test_torch_tpg import jax_outputs_to_port
from torch_host_lib import host_library

torch.set_num_threads(1)

TIMING_KEYS = ("rate_tp_hits_khz", "interval_seconds")
TICKS_PER_SC = 768


# ---- formats ----------------------------------------------------------------

def test_daphne_formats_match_jax():
    rng = np.random.default_rng(41)
    for stream in (False, True):
        size = daphne.STREAM_SUPERCHUNK_SIZE if stream \
            else daphne.SUPERCHUNK_SIZE
        sc = rng.integers(0, 256, (3, size), dtype=np.uint8)
        vals = rng.integers(0, 1 << 14, (36, 64, 4) if stream
                            else (36, 1024), dtype=np.uint16)
        got, want = sc.copy(), sc.copy()
        for mod, s in ((daphne, got), (jdaphne, want)):
            flat = mod.superchunk_frames(s, stream=stream) \
                .reshape(36, -1)
            if stream:
                mod.stream_set_adcs(flat, vals)
                mod.stream_set_header_field(flat, "link_id", 7)
            else:
                mod.set_waveform(flat, vals)
                mod.set_header_field(flat, "crate_id", 300)
            mod.fake_timestamps(s, 99_000, offset=64 if stream else 16,
                                stream=stream)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            daphne.get_first_timestamp(got, stream=stream),
            jdaphne.get_first_timestamp(want, stream=stream))
        flat = daphne.superchunk_frames(got, stream=stream).reshape(36, -1)
        np.testing.assert_array_equal(
            daphne.stream_get_adcs(flat) if stream
            else daphne.get_waveform(flat), vals)


def test_stream_unpack_matches_numpy_and_jnp():
    rng = np.random.default_rng(42)
    words = rng.integers(0, 1 << 32, (2, 5, 112), dtype=np.uint64) \
        .astype(np.uint32)                 # every bit pattern
    got = daphne.stream_unpack_frames(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (2, 5, 64, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdaphne.stream_unpack_frames_jnp(jnp.asarray(words))))
    frames = daphne.stream_empty_frames(6)
    adcs = rng.integers(0, 1 << 14, (6, 64, 4), dtype=np.uint16)
    daphne.stream_set_adcs(frames, adcs)
    words = daphne.stream_frames_bytes_to_u32(frames)
    np.testing.assert_array_equal(
        daphne.stream_unpack_frames(torch.from_numpy(words)).numpy(), adcs)


def test_relayout_time2_daphne_matches_jax():
    from fdreadoutlibs_tpu import native as jnative
    rng = np.random.default_rng(43)
    words = rng.integers(0, 1 << 32, (3, 4, 112), dtype=np.uint64) \
        .astype(np.uint32)
    got = native.relayout_time2_daphne(words)
    np.testing.assert_array_equal(got, jnative.relayout_time2_daphne(words))
    unpadded = native.relayout_time2_daphne(words, pad8=False)
    np.testing.assert_array_equal(unpadded, got[:, :1])


# ---- the self-triggered pulse finder ----------------------------------------

def selftrig_superchunks(rng, n):
    sc = daphne.empty_superchunks(n)
    frames = daphne.superchunk_frames(sc).reshape(-1, daphne.FRAME_SIZE)
    wf = (1000 + rng.normal(0, 6, (12 * n, 1024))).astype(np.uint16)
    for f in rng.choice(12 * n, 5 * n, replace=False):
        t0 = rng.integers(64, 1000)
        wf[f, t0:t0 + 20] += rng.integers(30, 600, 20).astype(np.uint16)
    daphne.set_waveform(frames, wf)
    daphne.set_header_field(frames, "link_id", np.arange(12 * n) % 64)
    daphne.fake_timestamps(sc, 10_000, offset=16)
    return sc


def test_selftriggered_pulse_finder_matches_jax():
    rng = np.random.default_rng(44)
    batches = [selftrig_superchunks(rng, 2) for _ in range(2)]
    outs = []
    for cls, queue in ((DAPHNEFrameProcessor, QueueSender),
                       (JSelfTrig, JQueue)):
        sink = queue()
        p = cls(tp_sink=sink)
        p.conf({"enable_tpg": True, "tpg_threshold": 50, "det_id": 2})
        p.start()
        for sc in batches:
            p.process(sc.copy())
        outs.append((np.concatenate(sink.drain()), p.last_processed_daq_ts,
                     p.metrics.count("num_hits")))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:] and len(outs[0][0]) >= 5


def test_selftriggered_emulator_matches_jax():
    outs = []
    for cls in (DAPHNEFrameProcessor, JSelfTrig):
        p = cls()
        p.conf({"emulator_mode": True})
        p.start()
        sc = daphne.empty_superchunks(3)
        p.process(sc[:2])
        p.process(sc[2:])
        outs.append(sc)
    np.testing.assert_array_equal(*outs)


# ---- the stream processor -----------------------------------------------------

def stream_batches(seed, n_batches=3, n_sc=1):
    """Batches of one link's stream superchunks: noise around 800, pulses
    over batch boundaries, and in batch 1 five closes on channel 3 within
    one 384-tick chunk (over K = 4)."""
    rng = np.random.default_rng(seed)
    out, ts = [], 40_000
    T = n_sc * TICKS_PER_SC
    for b in range(n_batches):
        sc = daphne.empty_superchunks(n_sc, stream=True)
        frames = daphne.superchunk_frames(sc, stream=True) \
            .reshape(-1, daphne.STREAM_FRAME_SIZE)
        adcs = (800 + rng.normal(0, 10, (T, 4))).astype(np.uint16)
        adcs[T - 5:, b % 4] += 500               # closes in the next batch
        adcs[100:106, (b + 1) % 4] += 400
        if b == 1:
            for i in range(5):
                adcs[200 + 12 * i:203 + 12 * i, 3] += 700
        daphne.stream_set_adcs(frames, adcs.reshape(-1, 64, 4))
        daphne.fake_timestamps(sc, ts, offset=64, stream=True)
        out.append(sc)
        ts += T
    return out


def drive_stream(proc, sink, batches):
    rows = []
    for sc in batches:
        proc.process(sc.copy())
        tps = sink.drain()
        st = proc.current_state()
        rows.append((np.concatenate(tps) if tps else None,
                     {k: np.array(v, copy=True) for k, v in st.items()},
                     proc.metrics.count("num_hits"),
                     proc.metrics.count("num_hits_dropped"),
                     proc.metrics.count("num_ts_errors")))
    return rows


@pytest.mark.parametrize("backend,compact", [("reference", True),
                                             ("scan", True),
                                             ("pallas", True),
                                             ("pallas", False)])
def test_stream_processor_matches_jax(backend, compact):
    batches = stream_batches(45)
    runs = []
    for cls, queue, kw in ((DAPHNEStreamFrameProcessor, QueueSender,
                            {"device": "cpu"}), (JStream, JQueue, {})):
        sink = queue()
        p = cls(tp_sink=sink, **kw)
        p.conf({"enable_tpg": True, "tpg_threshold": 150, "det_id": 2,
                "tpg_backend": backend, "tpg_pallas_interpret": True,
                "tpg_device_compact": compact})
        p.start()
        runs.append(drive_stream(p, sink, batches))
    for b, (got, want) in enumerate(zip(*runs)):
        assert (got[0] is None) == (want[0] is None), b
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], want[0], err_msg=str(b))
        assert got[2:] == want[2:], b
        for k in want[1]:
            if k in ("fir_prev", "fir_phase"):
                continue           # the threshold tick does not carry them
            np.testing.assert_array_equal(got[1][k], want[1][k],
                                          err_msg=f"batch {b} {k}")
    assert runs[0][-1][2] >= 6
    assert runs[0][-1][3] == (1 if backend == "pallas" else 0)


def test_stream_processor_state_is_lazy(monkeypatch):
    """current_state() unpacks the device state once per batch, not once
    per call (the JAX processor's staleness gate)."""
    from fdreadoutlibs_tpu_torch.stream import daphne as sdaphne
    calls = {"n": 0}
    real = sdaphne.unpack_state

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(sdaphne, "unpack_state", counting)
    p = DAPHNEStreamFrameProcessor(tp_sink=QueueSender(), device="cpu")
    p.conf({"enable_tpg": True, "tpg_threshold": 150,
            "tpg_backend": "pallas"})
    p.start()
    sc = stream_batches(46, n_batches=1)[0]
    p.process(sc.copy())
    st1 = p.current_state()
    assert calls["n"] == 1 and p.current_state() is st1 and calls["n"] == 1
    p.process(sc.copy())
    p.current_state()
    assert calls["n"] == 2


def test_stream_cadence_and_emulator_match_jax():
    outs = []
    for cls, kw in ((DAPHNEStreamFrameProcessor, {"device": "cpu"}),
                    (JStream, {})):
        counts = []
        for emulator in (False, True):
            p = cls(**kw)
            p.conf({"emulator_mode": emulator})
            p.start()
            sc = daphne.empty_superchunks(4, stream=True)
            for i in range(4):
                daphne.fake_timestamps(sc[i:i + 1], 1000 + i * 768 * (1 + i % 2),
                                       offset=64, stream=True)
            p.process(sc)
            counts.append((sc, p.metrics.count("num_ts_errors"),
                           p.last_processed_daq_ts))
        outs.append(counts)
    for (a, na, ta), (b, nb, tb) in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert (na, ta) == (nb, tb)
    assert outs[0][0][1] > 0 and outs[0][1][1] == 0


# ---- the ingest entry and StreamingIngest -------------------------------------

def pds_words(seed, L, N):
    rng = np.random.default_rng(seed)
    frames = np.zeros((L, N, daphne.STREAM_FRAME_SIZE), np.uint8)
    adcs = (800 + rng.normal(0, 8, (L, N, 64, 4))).astype(np.uint16)
    for l in range(L):
        adcs[l, 1, 5:13, l % 4] += 400
        adcs[l, N - 1, 60:, (l + 1) % 4] += 500
        daphne.stream_set_adcs(frames[l], adcs[l])
    return frames, daphne.stream_frames_bytes_to_u32(frames)


def test_process_packed_daphne_matches_jax():
    L, N = 3, 6                                   # 12 channels, 384 ticks
    cfg = TPGConfig(threshold=120)
    C = 4 * L
    _, words = pds_words(47, L, N)
    first = words[:, 0]
    st = seed_chanstate(init_chanstate(C), daphne.stream_unpack_frames(
        torch.from_numpy(first.view(np.int32)))[:, 0].reshape(-1).numpy(),
        cfg.rs_memory_factor_x10)
    stack = jtpg.pack_state(st, C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    for half in (words[:, :N // 2], words[:, N // 2:]):
        js, jn, stack = jingest.process_packed_daphne(
            jnp.asarray(half), stack, cfg, C, tc=64, k_slots=2,
            unroll=1, interpret=True)
        slots, nclose, state = ingest.process_packed_daphne(
            torch.from_numpy(np.ascontiguousarray(half).view(np.int32)),
            state, cfg, C, tc=64, k_slots=2)
        js, jn = jax_outputs_to_port(js, jn, C)
        np.testing.assert_array_equal(slots.numpy(), js)
        np.testing.assert_array_equal(nclose.numpy(), jn)
        np.testing.assert_array_equal(
            state.numpy(), tpg.state_from_jax(np.asarray(stack), C).numpy())
    with pytest.raises(ValueError):
        ingest.process_packed_daphne(
            torch.from_numpy(words.view(np.int32)), state, cfg, C + 4)


@pytest.mark.parametrize("compact,time2", [(False, False), (True, False),
                                           (True, True)])
def test_streaming_ingest_daphne_matches_jax(compact, time2):
    L, NB, NF = 2, 3, 4
    cfg = TPGConfig(threshold=120)
    ings = [ingest.StreamingIngest(cfg, L, format="daphne_stream",
                                   device_compact=compact, time2=time2,
                                   device="cpu"),
            jingest.StreamingIngest(cfg, L, interpret=True,
                                    format="daphne_stream",
                                    device_compact=compact, time2=time2)]
    outs = [[], []]
    for b in range(NB):
        frames, _ = pds_words(48 + b, L, NF)
        for ing, out in zip(ings, outs):
            res = ing.submit(frames.copy())
            if res is not None:
                out.append(res)
    for ing, out in zip(ings, outs):
        out.append(ing.flush())
    assert len(outs[0]) == len(outs[1]) == NB
    for (h, d), (jh, jd) in zip(*outs):
        np.testing.assert_array_equal(h, jh)
        assert d == jd
    assert sum(len(h) for h, _ in outs[0]) >= 2 * L


# ---- the app ----------------------------------------------------------------

def app_batches(seed, L=2, M=2, n=3):
    rng = np.random.default_rng(seed)
    ts, out = 0x2000000, []
    for _ in range(n):
        scs, adcs = make_batch(rng, L, M, ts, signal_rate=0.6)
        out.append(scs)
        ts += adcs.shape[1]
    return out


def run_app(app, batches):
    fetched = []
    fetch = app._fetch_hits

    def recording(packed):
        out = fetch(packed)
        fetched.append(out)
        return out
    app._fetch_hits = recording
    for scs in batches:
        app.process_batch(scs.copy())
    app.flush()
    info = app.get_info()
    info["handler"] = {k: v for k, v in info["handler"].items()
                       if k not in TIMING_KEYS}
    raw = app.request_raw(1, 0x2000000 + 100, 0x2000000 + 2000)
    return (fetched, info, app.handler.buffer.snapshot(),
            app.tpset_q.drain(), raw)


@pytest.fixture(scope="module")
def pds_batches():
    return app_batches(49)


@pytest.fixture(scope="module")
def jax_pds(pds_batches):
    """The JAX app's sync run in interpret mode (pipelined gives the same
    stream: the JAX package's own test holds that)."""
    with jax_interpret():
        return run_app(JaxPDS(n_links=2), pds_batches)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_pds_app_matches_jax(pipelined, pds_batches, jax_pds):
    got = run_app(PDSReadoutApp(n_links=2, pipelined=pipelined,
                                device="cpu"), pds_batches)
    (fa, ia, ta, sa, ra), (fb, ib, tb, sb, rb) = got, jax_pds
    assert len(fa) == len(fb) == len(pds_batches)
    for (ha, da), (hb, db) in zip(fa, fb):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    assert ia == ib
    np.testing.assert_array_equal(ta, tb)
    assert_same_tpsets(sa, sb)
    np.testing.assert_array_equal(ra, rb)
    assert ia["total_hits"] > 0 and ia["ts_errors"] == 0 and len(ra) > 0


def test_pds_app_refuses_a_small_raw_capacity():
    app = PDSReadoutApp(n_links=1, raw_capacity_superchunks=2, device="cpu")
    with pytest.raises(ValueError):
        app.process_batch(app_batches(50, L=1, M=2, n=1)[0])


def test_pds_k2_host_build_at_40_channels(monkeypatch):
    """The card's kernel built for the host at the PDS app's width (10
    links, 40 channels: a full block of 32 and a partial one of 8) under
    the app: the same fetched hits as the plain version."""
    lib = host_library("tpg")
    fn = lib.tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    batches = app_batches(51, L=10, M=1, n=2)
    plain = run_app(PDSReadoutApp(n_links=10, device="cpu"), batches)
    shapes = []

    def host_window(feed, state, cfg, tc, k_slots, time_packed=True,
                    packed14=None, fir_twopass=0, **kw):
        assert not time_packed and packed14 is None and not fir_twopass
        shapes.append(tuple(feed.shape))
        # launch_kernel's own check: the kernel takes contiguous tensors
        assert feed.is_contiguous() and state.is_contiguous()
        return tpg._launch(fn, feed, state, cfg, tc, k_slots, False, None, 0,
                           None, lib=lib)

    monkeypatch.setattr(ingest, "process_window", host_window)
    host = run_app(PDSReadoutApp(n_links=10, device="cpu"), batches)
    assert shapes == [(TICKS_PER_SC, 40)] * 2
    for (h, d), (ph, pd) in zip(host[0], plain[0]):
        np.testing.assert_array_equal(h, ph)
        assert d == pd
    assert_same_tpsets(host[3], plain[3])
    assert plain[1]["total_hits"] > 0
