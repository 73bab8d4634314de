"""The port's TDE path against the JAX package's, on the CPU: the TDE16
format accessors, the vertical-drift channel map, and
``TDEFrameProcessor`` under the "reference", "scan" and "pallas" backends
(the port's "scan" and "pallas" on ``device="cpu"``, the kernel's plain
version; the JAX "pallas" in Pallas interpret mode, as ``run_model`` runs
it off the TPU) over a batch sequence with a pulse across a batch
boundary, more closes in one 512-tick window than its 8 slots, an
active-channel change and back, two cycles in one batch and an
incomplete batch: TPs, carried state and counters bit-equal (tolerance 0,
an integer pipeline).  The card's K2 at 64 channels (windows of 512 ticks
and the 333-tick tail of a 5965-tick cycle) runs here built for the host
(``tests/torch_host_lib.py``) under the same processor."""

import ctypes

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.formats import tde as jtde
from fdreadoutlibs_tpu.stream.tde import TDEFrameProcessor as JTDE
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueue
from fdreadoutlibs_tpu.utils import channel_map as jcmap
from fdreadoutlibs_tpu_torch.formats import tde
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.stream import TDEFrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.utils import channel_map as cmap
from torch_host_lib import host_library

torch.set_num_threads(1)

S = tde.TOT_ADC16_SAMPLES
TICK = tde.EXPECTED_TICK_DIFFERENCE
TS0 = 0x300000
COUNTERS = ("num_hits", "num_tps_sent", "num_ts_errors",
            "num_tpg_channel_set_changes", "num_incomplete_tpg_batches")


def cycle(rng, channels, ts, pulses=(), n_cycles=1):
    """n_cycles complete cycles of TDE frames for ``channels`` (interleaved
    in channel order per cycle), noise around 8000 ADC, ``pulses`` as
    (cycle, channel, first sample, length, height)."""
    C = len(channels)
    frames = tde.empty_frames(n_cycles * C)
    samples = (8000 + rng.normal(0, 20, (n_cycles, C, S))).astype(np.uint16)
    for k, ch, t0, n, h in pulses:
        samples[k, list(channels).index(ch), t0:t0 + n] += np.uint16(h)
    tde.set_channel(frames, np.tile(channels, n_cycles))
    tde.set_timestamp(frames, np.repeat(
        ts + TICK * np.arange(n_cycles, dtype=np.uint64), C))
    tde.set_adc_samples(frames, samples.reshape(n_cycles * C, S))
    return frames


def batches():
    """The batch sequence the processors are driven with."""
    rng = np.random.default_rng(31)
    full = np.arange(64)
    less = np.setdiff1d(full, [5, 40])
    burst = [(0, 20, 600 + 12 * i, 3, 1500) for i in range(10)]
    out = [cycle(rng, full, TS0, [(0, 9, S - 6, 12, 3000), *burst]),
           cycle(rng, less, TS0 + TICK, [(0, 9, 0, 4, 3000),
                                         (0, 33, 2000, 20, 2500)]),
           cycle(rng, full, TS0 + 2 * TICK, [(0, 5, 100, 10, 2000),
                                             (0, 40, S - 3, 10, 2000)]),
           cycle(rng, full, TS0 + 3 * TICK, [(0, 40, 0, 6, 2000),
                                             (1, 63, 5000, 30, 1800)],
                 n_cycles=2)]
    # two cycles less one frame: channel 63 has one frame, the rest two
    out.append(cycle(rng, full, TS0 + 5 * TICK, n_cycles=2)[:-1])
    return out


def drive(proc, sink, frames_seq):
    """Each batch through ``proc``: (TPs, state, counters) per batch."""
    per_batch = []
    for frames in frames_seq:
        proc.process(frames.copy())
        tps = sink.drain()
        per_batch.append((np.concatenate(tps) if tps else None,
                          {k: np.array(v, copy=True)
                           for k, v in (proc._state or {}).items()},
                          {k: proc.metrics.count(k) for k in COUNTERS}))
    return per_batch


def conf(backend, mapped):
    c = {"enable_tpg": True, "tpg_threshold": 600, "tpg_backend": backend,
         "det_id": 11}
    if mapped:
        c.update(channel_map_name="VDTDEChannelMap", crate_id=5, slot_id=3)
    return c


def assert_same(got, want):
    assert len(got) == len(want)
    for b, ((tps, st, cnt), (wtps, wst, wcnt)) in enumerate(zip(got, want)):
        assert cnt == wcnt, b
        assert (tps is None) == (wtps is None), b
        if tps is not None:
            np.testing.assert_array_equal(tps, wtps, err_msg=f"batch {b}")
        assert sorted(st) == sorted(wst), b
        for k in st:
            np.testing.assert_array_equal(st[k], wst[k],
                                          err_msg=f"batch {b} {k}")


@pytest.fixture(scope="module")
def seq():
    return batches()


@pytest.fixture(scope="module")
def jax_runs(seq):
    """The JAX processor's run per (backend, mapped), made once."""
    cache = {}

    def get(backend, mapped):
        if (backend, mapped) not in cache:
            sink = JQueue()
            p = JTDE(tp_sink=sink)
            p.conf(conf(backend, mapped))
            p.start()
            cache[backend, mapped] = drive(p, sink, seq)
        return cache[backend, mapped]
    return get


@pytest.mark.parametrize("backend,mapped", [("reference", False),
                                            ("reference", True),
                                            ("scan", True),
                                            ("pallas", True)])
def test_tde_processor_matches_jax(backend, mapped, seq, jax_runs):
    sink = QueueSender()
    port = TDEFrameProcessor(tp_sink=sink, device="cpu")
    port.conf(conf(backend, mapped))
    port.start()
    got = drive(port, sink, seq)
    want = jax_runs(backend, mapped)
    assert_same(got, want)
    counts = got[-1][2]
    assert counts["num_tpg_channel_set_changes"] == 2
    assert counts["num_incomplete_tpg_batches"] == 1
    assert counts["num_ts_errors"] == 2          # channels 5 and 40
    tps = np.concatenate([t for t, _, _ in got if t is not None])
    assert len(tps) >= 6
    if mapped:      # offline channels of crate 5 (CRP 1, crate 1 in it),
        # AMC slot 3
        assert (tps["channel"] // 64 == (3072 + (12 + 3) * 64) // 64).all()
    if backend == "pallas":
        # 8 slots per 512-tick window: the burst's 10 closes on channel 20
        # keep 8, where the oracle keeps every close
        oracle = jax_runs("reference", True)[-1][2]
        assert oracle["num_hits"] - counts["num_hits"] == 2


def test_emulator_timestamps_match_jax():
    rng = np.random.default_rng(32)
    frames = cycle(rng, np.arange(64), TS0, n_cycles=2)
    tde.set_timestamp(frames, rng.integers(0, 1 << 40, len(frames),
                                           dtype=np.uint64))
    outs = []
    for p in (TDEFrameProcessor(device="cpu"), JTDE()):
        p.conf({"emulator_mode": True})
        p.start()
        f = frames.copy()
        p.process(f[:64])
        p.process(f[64:])
        outs.append((f, p.metrics.count("num_ts_errors"),
                     p.last_processed_daq_ts))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


def test_tde_format_matches_jax():
    rng = np.random.default_rng(33)
    frames = rng.integers(0, 256, (6, tde.FRAME_SIZE), dtype=np.uint8)
    got, want = frames.copy(), frames.copy()
    ch = rng.integers(0, 64, 6)
    ts = rng.integers(0, 1 << 62, 6, dtype=np.uint64)
    samples = rng.integers(0, 1 << 16, (6, S), dtype=np.uint64) \
        .astype(np.uint16)
    for mod, f in ((tde, got), (jtde, want)):
        mod.set_channel(f, ch)
        mod.set_timestamp(f, ts)
        mod.set_adc_samples(f, samples)
        mod.set_adc_sample(f, 77, 5)
        mod.fake_geoid(f, 3, 7, 0)
        mod.set_daq_header_field(f, "version", 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tde.sort_key(got), jtde.sort_key(want))
    np.testing.assert_array_equal(tde.get_channel(got), ch)
    for name in ("crate_id", "slot_id", "version"):
        np.testing.assert_array_equal(tde.get_daq_header_field(got, name),
                                      jtde.get_daq_header_field(want, name))
    assert (tde.FRAME_SIZE, tde.EXPECTED_TICK_DIFFERENCE) == \
        (jtde.FRAME_SIZE, jtde.EXPECTED_TICK_DIFFERENCE)


@pytest.mark.parametrize("crate,slot", [(0, 0), (5, 3), (9, 11)])
def test_vdtde_channel_map_matches_jax(crate, slot):
    perm = np.random.default_rng(crate).permutation(3072)
    for kw in ({}, {"permutation": perm}):
        port = cmap.make_map("VDTDEChannelMap", **kw)
        ref = jcmap.make_map("VDTDEChannelMap", **kw)
        off = port.offline_channels(crate, slot, 0, 64)
        np.testing.assert_array_equal(off, ref.offline_channels(crate, slot,
                                                                0, 64))
        np.testing.assert_array_equal(port.planes(off), ref.planes(off))
        assert port.get_offline_channel_from_crate_slot_stream_chan(
            crate, slot, 0, 17) == \
            ref.get_offline_channel_from_crate_slot_stream_chan(
                crate, slot, 0, 17)
    assert isinstance(cmap.make_map("VDTopChannelMap"), cmap.VDTDEChannelMap)
    with pytest.raises(ValueError):
        cmap.make_map("VDTDEChannelMap").offline_channels(0, 12, 0, 64)


def test_tde_k2_host_build_matches_jax(seq, jax_runs, monkeypatch):
    """The card's kernel built for the host (K2: 64 channels, windows of
    512 ticks and the 333-tick tail) under the TDE processor's "pallas"
    backend: the same TPs and state as the JAX processor's."""
    lib = host_library("tpg")
    fn = lib.tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    shapes = []

    def host_window(feed, state, cfg, tc, k_slots, time_packed=True,
                    packed14=None, fir_twopass=0, **kw):
        assert not time_packed and packed14 is None and not fir_twopass
        shapes.append((tuple(feed.shape), tc))
        # launch_kernel's own check: the kernel takes contiguous tensors
        assert feed.is_contiguous() and state.is_contiguous()
        return tpg._launch(fn, feed, state, cfg, tc, k_slots, False, None, 0,
                           None, lib=lib)

    monkeypatch.setattr(tpg, "process_window", host_window)
    sink = QueueSender()
    port = TDEFrameProcessor(tp_sink=sink, device="cpu")
    port.conf(conf("pallas", True))
    port.start()
    got = drive(port, sink, seq[:2])
    assert_same(got, jax_runs("pallas", True)[:2])
    assert ((512, 64), 512) in shapes and ((333, 64), 333) in shapes
    assert ((333, 62), 333) in shapes            # the changed channel set
