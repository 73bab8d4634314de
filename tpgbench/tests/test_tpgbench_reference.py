"""The plain reference on hand-made inputs: the frame pack and unpack
round trip, hand-placed pulses found where they were put, TP assembly
and TPSet windowing on a hand case."""

import numpy as np
import pytest
import torch

from tpgbench.reference import channels, frames, tpg, tps
from tpgbench.generators.wibeth_slabs import Source, pack_frames

PARAMS = dict(threshold=150, accumulator_limit=10, scale_x10=5, tc=256,
              k_slots=4)


def test_pack_unpack_round_trip():
    g = torch.Generator().manual_seed(3)
    adcs = torch.randint(0, 1 << 14, (3, 2, 64, 64), generator=g,
                         dtype=torch.int32)
    raw = pack_frames(adcs).numpy().view(np.uint8)
    got = frames.unpack_adcs(raw)                       # (2 * 64, 3 * 64)
    want = adcs.numpy().transpose(1, 2, 0, 3).reshape(128, 192)
    np.testing.assert_array_equal(got, want)


def test_headers_continue_over_the_ring():
    cfg = {"links": 2, "crate": 1, "det_id": 3}
    traffic = {"frames_per_batch": 4, "pedestal": 900, "noise_sigma": 30,
               "pulse_rate_per_channel_frame": 0.0, "pulse_adc": [300, 3000],
               "pulse_ticks": 8, "pulse_start_ticks": 50}
    src = Source(cfg, traffic, 5, torch.device("cpu"), 1, 2)
    ts = []
    for b in range(5):
        fr = src.batch(0, b)
        assert (frames.header_field(fr, "seq_id")[1] ==
                (np.arange(4) + 4 * b) % 4096).all()
        assert (frames.header_field(fr, "slot_id") == 0).all()
        assert (frames.header_field(fr, "stream_id")[:, 0] == [0, 1]).all()
        assert (frames.header_field(fr, "det_id") == 3).all()
        ts.append(frames.timestamps(fr)[0])
    steps = np.diff(np.concatenate(ts))
    assert (steps == frames.CLOCKS_PER_FRAME).all()


def quiet_with_pulses(T, C, pulses):
    adcs = np.full((T, C), 900, dtype=np.int32)
    for c, t0, amp, width in pulses:
        adcs[t0:t0 + width, c] += amp
    return adcs


@pytest.mark.parametrize("collection", [True, False])
def test_hand_placed_pulses(collection):
    T, C = 1024, 4
    pulses = [(1, 100, 1000, 8), (3, 600, 1300 if not collection else 2500,
                                   8)]
    adcs = quiet_with_pulses(T, C, pulses)
    mf = np.full(C, 0 if collection else 8, dtype=np.int32)
    closes, nclose, _ = tpg.run(adcs, tpg.seed_state(adcs[0], mf), **PARAMS)
    hits, dropped = tpg.batch_hits(closes, nclose, ticks=slice(0, T),
                                   tc=256, k_slots=4, max_hits=100)
    assert dropped == 0
    assert list(hits["channel"]) == [1, 3]
    for i, (c, t0, amp, width) in enumerate(pulses):
        end = hits["end_tick"][i]
        start = end - hits["tover"][i]
        if collection:
            # memoryless RS: over exactly while the pulse is, |s| / 2 > 150
            assert (start, end) == (t0, t0 + width)
            assert hits["charge"][i] == amp * width
        else:
            # the running sum starts with the pulse and outlasts it
            assert start == t0 and end > t0 + width
            assert hits["charge"][i] >= amp * width
        assert hits["peak_adc"][i] == amp


def test_running_sum_wraps_at_int16():
    """On an induction channel (memory 0.8) the x10 sum 8 rs + 5 |s| passes
    the int16 range once |s| > 1310: the AVX2 arithmetic wraps and the
    pulse's hit splits in two, as the deployed kernels do."""
    adcs = quiet_with_pulses(512, 1, [(0, 100, 2500, 8)])
    st = tpg.seed_state(adcs[0], np.full(1, 8, np.int32))
    closes, _, _ = tpg.run(adcs, st, **PARAMS)
    assert list(closes["tick"]) == [103, 120]


def test_slots_and_cap_count_what_they_drop():
    T, C = 512, 2
    # six short pulses in one 256-tick chunk of channel 0: two dropped
    pulses = [(0, 10 + 30 * k, 1000, 4) for k in range(6)]
    adcs = quiet_with_pulses(T, C, pulses)
    st = tpg.seed_state(adcs[0], np.zeros(C, np.int32))
    closes, nclose, _ = tpg.run(adcs, st, **PARAMS)
    hits, dropped = tpg.batch_hits(closes, nclose, ticks=slice(0, T),
                                   tc=256, k_slots=4, max_hits=100)
    assert len(hits["channel"]) == 4 and dropped == 2
    hits, dropped = tpg.batch_hits(closes, nclose, ticks=slice(0, T),
                                   tc=256, k_slots=4, max_hits=3)
    assert len(hits["channel"]) == 3 and dropped == 3
    assert list(hits["end_tick"]) == sorted(hits["end_tick"])


def test_channel_map_and_memory_factors():
    off, coll = channels.link_channels(40, crate=1)
    assert sorted(off) == list(range(2560, 5120))
    assert coll.sum() == 960
    mf = channels.memory_factors(coll, 8, True)
    assert set(mf[coll]) == {0} and set(mf[~coll]) == {8}


def test_assembly_and_windowing():
    hits = {"channel": np.array([0, 65]), "end_tick": np.array([10, 20]),
            "charge": np.array([-1, 0]), "tover": np.array([4, 5]),
            "peak_adc": np.array([7, 8]), "peak_time": np.array([1, 2])}
    t_base = np.array([1000, 2000])
    got = tps.assemble(hits, t_base, np.arange(128) + 500, 3, 100000)
    # a zero charge makes no TP; a negative one crosses as its uint16
    assert list(got["channel"]) == [500]
    assert got["adc_integral"][0] == 0xFFFF
    assert got["time_start"][0] == 1000 + 32 * 6
    assert got["time_peak"][0] == 1000 + 32 * 7
    w = tps.Windowing(100)
    one = {k: np.array([v[0]] * 3) for k, v in got.items()}
    one["time_start"] = np.array([50, 120, 400])
    s = w.finish_batch(one, 300)
    assert s["type"] == tps.PAYLOAD and s["seqno"] == 0
    assert (s["start_time"], s["end_time"]) == (50, 120)
    assert w.cutoff == 120 and w.start == 300
    late = dict(one, time_start=np.array([110, 700, 705]))
    s = w.finish_batch(late, 750)
    # the TP before the cutoff is tardy; [300, 650) holds only the 400
    assert (s["start_time"], s["end_time"]) == (400, 400)
    s = w.finish_batch(tps.empty(), 760)
    assert s is None or s["type"] == tps.HEARTBEAT
