"""The ProtoDUNE-SP cell ``pdsp_apa_protowib.nominal`` through the port's
CPU plain path at a cut size (two links, 64 superchunks a batch): the
result line, ``correct`` true and the control false; its batch seconds
and least bytes written out; a configuration that states what the
processors do not run is refused; the generator's frames; the reference
imports nothing of the port or JAX."""

import argparse
import ast
import time

import pytest
import torch

from tpgbench import harness, judge, spec
from tpgbench.control import CONTROL_MASK
from tpgbench.generators.protowib_slabs import Source
from tpgbench.reference.protowib import frames
from tpgbench.systems import protowib_apa

BENCH = spec.load_benchmark()
CELL = "pdsp_apa_protowib.nominal"
CONFIG = "pdsp_apa_protowib"
# two links and 64 superchunks a batch: a few batches in seconds on the
# CPU, each longer than the handler's timeout and a TPSet window
CUT = {"links": 2, "frames_per_batch": 768}
SECONDS = 16.0


def test_cell_line_and_control():
    args = argparse.Namespace(workload=CELL, seed=2**31 + 23,
                              seconds=SECONDS, trace=0)
    # one link: batches short enough that the window holds four on a
    # loaded host
    res = harness.run_cell(BENCH, args, torch.device("cpu"),
                           time.monotonic(), dict(CUT, links=1))
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {
        "tpset_records_differing", "dropped_differing",
        "tps_suppressed_differing", "state_words_differing"}
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"rtf", "setup_s"}
    assert harness.banned_modules() == []


def test_control_fails_and_faults_are_caught():
    r = harness.Run(BENCH, CELL, 5, torch.device("cpu"), dict(CUT))
    r.warm(1)
    r.system.start_window(5)
    for _ in range(5):
        r.system.step()
    r.system.stop_window()
    r.system.finish()
    readings = r.system.judge()
    assert judge.correct(readings), readings
    ctrl = r.system.judge(r.system.control_outputs(CONTROL_MASK))
    assert not judge.correct(ctrl)
    out = r.system.outputs()
    b = next(b for b in sorted(out["sets"]) if out["sets"][b][1])
    out["sets"][b][1][0]["end_time"] += 1
    assert r.system.judge(out)["tpset_records_differing"]["value"] == 1
    out = r.system.outputs()
    k = sorted(out["states"])[-1]
    out["states"][k][0]["q75"][3] += 1
    assert r.system.judge(out)["state_words_differing"]["value"] == 1


def test_tps_judged_at_the_batch_end_are_caught(monkeypatch):
    """A processor that hands its handler the batch's end for every TP, and
    so suppresses TPs that upstream's one call a superchunk keeps, reads
    ``tps_suppressed_differing`` non-zero."""
    from fdreadoutlibs_tpu_torch.stream.protowib import WIBFrameProcessor
    from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
    emit, add = WIBFrameProcessor._emit_tps, WIBTPHandler.add_tps
    end = {}

    def emit_at_batch_end(self, hits, offlines, timestamp):
        end["now"] = timestamp + 25 * CUT["frames_per_batch"]
        return emit(self, hits, offlines, timestamp)

    def add_at_batch_end(self, tps, current_time):
        return add(self, tps, end["now"])
    monkeypatch.setattr(WIBFrameProcessor, "_emit_tps", emit_at_batch_end)
    monkeypatch.setattr(WIBTPHandler, "add_tps", add_at_batch_end)
    r = harness.Run(BENCH, CELL, 11, torch.device("cpu"), dict(CUT))
    r.warm(1)
    r.system.start_window(11)
    for _ in range(4):
        r.system.step()
    r.system.stop_window()
    r.system.finish()
    readings = r.system.judge()
    assert readings["tps_suppressed_differing"]["value"] > 0, readings
    assert not judge.correct(readings)


def test_per_layer_rows_sum_the_links():
    r = harness.Run(BENCH, CELL, 7, torch.device("cpu"), dict(CUT))
    r.warm(1)
    r.system.start_window(7)
    r.system.step()
    r.deliveries = r.system.stop_window()
    r.layer, r.window_s = r.system.layer_record(), 1.0
    rec = r.record()
    rows = rec["batch_timings"]
    assert len(rows) == 1
    links = [p.batch_timings[-1] for p in r.system.procs]
    for key in ("checks_ms", "codec_ms", "total_ms", "tpg_launch_ms"):
        assert rows[0][key] == pytest.approx(sum(x[key] for x in links))
    names = [m["name"] for m in spec.metrics_of(BENCH, CELL, True)]
    assert {"checks_ms", "fir_device_ms", "codec_ms.protowib",
            "launches_per_batch"} <= set(names)
    values = harness.metric_values(BENCH, CELL, rec, True)
    # on the CPU: the host spans read, the device ones and the trace's not
    assert values["checks_ms"]["value"] == rows[0]["checks_ms"]
    spans = sum(rows[0][k] for k in (
        "checks_ms", "codec_ms", "h2d_host_ms", "tpg_launch_ms",
        "compact_launch_ms", "fetch_ms", "assembly_ms", "handler_ms"))
    assert values["host_unnamed_ms.protowib"]["value"] == pytest.approx(
        rows[0]["total_ms"] - spans)
    assert 0 <= values["host_unnamed_ms.protowib"]["value"] \
        < rows[0]["total_ms"]
    for name in ("fir_device_ms", "compact_device_ms.protowib",
                 "device_idle"):
        assert name not in values
    # a program whose processors keep no rows: every span reader silent
    silent = dict(rec, batch_timings=[])
    assert harness.metric_values(BENCH, CELL, silent, True) == {}


def test_batch_seconds_and_least_bytes():
    cfg, tr = spec.configuration(BENCH, CONFIG), spec.traffic(
        "protowib_nominal")
    assert (cfg["links"], tr["frames_per_batch"]) == (10, 8448)
    assert protowib_apa.batch_seconds(cfg, tr) == 0.004224
    hits = 901.5
    want = (2560 * 8448 * 12 / 8 + 2560 * (17 + 17) * 2 + hits * 24)
    assert protowib_apa.least_bytes(cfg, tr, hits) == want
    assert 2560 * 8448 * 12 / 8 == 32_440_320


def test_run_batch_seconds():
    r = harness.Run(BENCH, CELL, 3, torch.device("cpu"), dict(CUT))
    assert r.batch_s == 768 * 25 / 50e6
    cfg = dict(spec.configuration(BENCH, CONFIG))
    tr = spec.traffic("protowib_nominal")
    assert protowib_apa.batch_seconds(cfg, tr) == 0.004224


@pytest.mark.parametrize("key, value", [
    ("collection_threshold", 6), ("induction_threshold", 4), ("tc", 128),
    ("k_slots", 2), ("fir_twopass", 1), ("tp_timeout", 20000),
    ("tpset_window_size", 3200), ("min_collection_offline", 0),
    ("feed", "packed")])
def test_configuration_states_what_the_processors_run(key, value):
    with pytest.raises((ValueError, RuntimeError), match=key):
        harness.Run(BENCH, CELL, 5, torch.device("cpu"),
                    dict(CUT, **{key: value}))


def test_tc_is_the_chunk_the_processor_picks():
    assert protowib_apa.chunk_ticks(8448, 256) == 256
    assert protowib_apa.chunk_ticks(8208, 256) == 228
    assert protowib_apa.chunk_ticks(12 * 7, 256) == 84


def test_generator_timestamps_continuous_and_errors_clear():
    cfg = dict(spec.configuration(BENCH, CONFIG), links=3)
    tr = dict(spec.traffic("protowib_nominal"), frames_per_batch=120)
    src = Source(cfg, tr, 2**40 + 1, torch.device("cpu"), 1, 2)
    prev = None
    for b in range(5):
        raw = torch.from_numpy(src.batch(0, b).copy()).view(
            3, -1, frames.FRAME_BYTES)
        ts = frames.timestamps(raw)
        assert bool((ts == ts[:1]).all())        # every link alike
        steps = torch.diff(ts[0])
        assert bool((steps == frames.CLOCKS_PER_TICK).all())
        assert int(ts[0, 0]) == src.batch_ts(b)
        if prev is not None:
            assert int(ts[0, 0]) - prev == frames.CLOCKS_PER_TICK
        prev = int(ts[0, -1])
        assert int(frames.wib_errors(raw).max()) == 0
        adcs = frames.decode(raw)
        assert 0 <= int(adcs.min()) and int(adcs.max()) < 4096
    # same seed, same samples; another seed, others
    again = Source(cfg, tr, 2**40 + 1, torch.device("cpu"), 1, 2)
    other = Source(cfg, tr, 2**40 + 2, torch.device("cpu"), 1, 2)
    def samples(source):
        return frames.decode(torch.from_numpy(source.slab(0, 0)).view(
            3, -1, frames.FRAME_BYTES))
    assert torch.equal(samples(src), samples(again))
    assert not torch.equal(samples(src), samples(other))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0] if node.level == 0
                      else "." * node.level + (node.module or ""))
    return names


@pytest.mark.parametrize("name", ["__init__.py", "frames.py", "fir_iqr.py",
                                  "wib_tpsets.py"])
def test_reference_is_plain_pytorch(name):
    path = spec.PKG / "reference" / "protowib" / name
    names = _imports(path)
    absolute = {n for n in names if not n.startswith(".")}
    assert absolute <= {"__future__", "math", "torch"}, absolute
    assert all(n.startswith(".") and not n.startswith("..")
               for n in names - absolute)


def _state_unchanged(orig):
    def f(feed, state, *a, **kw):
        slots, nclose, _ = orig(feed, state, *a, **kw)
        return slots, nclose, state
    return f


def _half_left_out(orig):
    def f(feed, state, *a, **kw):
        slots, nclose, new = orig(feed, state, *a, **kw)
        half = slots.shape[0] // 2
        slots, nclose = slots.clone(), nclose.clone()
        slots[half:] = 0
        nclose[half:] = 0
        return slots, nclose, new
    return f


def _answer_altered(orig):
    def f(*a, **kw):
        hits, dropped = orig(*a, **kw)
        if len(hits):
            hits = hits.copy()
            hits["charge"][len(hits) // 2] += 1
        return hits, dropped
    return f


# the processor's entries: the FIR launch and the compact-hit fetch
PROC = "fdreadoutlibs_tpu_torch.stream.protowib"
FAULTS = {"state_unchanged": ("process_time2_feed", _state_unchanged),
          "half_left_out": ("process_time2_feed", _half_left_out),
          "answer_altered": ("unpack_compact", _answer_altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    """Each fault in the processors' path, in every call, reads
    ``correct`` false."""
    import importlib
    name, wrap = FAULTS[fault]
    m = importlib.import_module(PROC)
    monkeypatch.setattr(m, name, wrap(getattr(m, name)))
    r = harness.Run(BENCH, CELL, 11, torch.device("cpu"),
                    dict(CUT, pulse_rate_per_channel_tick=0.002))
    r.warm(1)
    r.system.start_window(11)
    for _ in range(4):
        r.system.step()
    r.system.stop_window()
    r.system.finish()
    assert not judge.correct(r.system.judge())


@pytest.mark.parametrize("plane_counters", [True, False])
def test_drops_compared_a_plane_or_a_link(monkeypatch, plane_counters):
    """Busy batches that drop hits read ``correct`` true, a link-plane at a
    time where the processors count each plane, a link at a time where
    they do not (an older program that keeps no plane counts)."""
    if not plane_counters:
        monkeypatch.setattr(protowib_apa, "plane_counts", lambda p: None)
    r = harness.Run(BENCH, CELL, 77, torch.device("cpu"),
                    dict(CUT, pulse_rate_per_channel_tick=0.02))
    r.warm(1)
    r.system.start_window(77)
    for _ in range(4):
        r.system.step()
    deliveries = r.system.stop_window()
    r.system.finish()
    assert r.system.per_plane is plane_counters
    assert all(r.system.dropped_of(a, b) > 0 for a, b in deliveries)
    readings = r.system.judge()
    assert judge.correct(readings), readings
    out = r.system.outputs()
    out["dropped"][deliveries[-1][1]][1, 0] += 1
    assert r.system.judge(out)["dropped_differing"]["value"] == 1
