"""The port's stage spans (``utils.logging.span``) and the APA app's
``batch_timings`` rows built from them, on the CPU: a span adds its host
milliseconds to its row and opens a profiler range only while a profiler
records; under ``torch.profiler`` every ``apa.*`` stage is a range inside
the caller's own; each row holds the ten host stages, ``step_ms`` and
``total_ms`` (no device keys off a card), and its spans fit inside its
``step_ms``.  The device events are checked on the card
(``tests/test_torch_cuda.py``)."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fdreadoutlibs_tpu_torch.apps.apa_readout import (APAReadoutApp,
                                                      make_batch)
from fdreadoutlibs_tpu_torch.utils import logging as tlog
from fdreadoutlibs_tpu_torch.utils.logging import span

torch.set_num_threads(1)

L, N = 2, 4
PROD = dict(algorithm="AbsRS", threshold=150, threshold_on_collection=True,
            time2_feed=True)
# range name -> row key
SPANS = {"apa.preprocess": "preprocess_ms", "apa.retention": "retention_ms",
         "apa.words": "words_ms", "apa.codec": "codec_ms",
         "apa.h2d": "h2d_host_ms", "apa.tpg": "tpg_launch_ms",
         "apa.compact": "compact_launch_ms", "apa.fetch": "fetch_ms",
         "apa.assembly": "assembly_ms", "apa.handler": "handler_ms"}
# perf_counter differences summed in another order than they were taken
ROUNDING_MS = 1e-6


def batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [make_batch(rng, L, N, b, 0x1000000 + b * N * 2048,
                       signal_rate=0.5)[0] for b in range(n)]


def run_app(n, pipelined, flush=True):
    app = APAReadoutApp(n_links=L, device="cpu", pipelined=pipelined, **PROD)
    for frames in batches(n):
        app.process_batch(frames)
    if flush:
        app.flush()
    return list(app.batch_timings)


def test_span_adds_its_milliseconds_and_opens_no_range_unprofiled(
        monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def recording(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    row = {}
    with span("apa.codec", row):
        time.sleep(0.004)
    first = row["codec_ms"]
    with span("apa.codec", row):
        time.sleep(0.002)
    with span("apa.h2d", row, "h2d_host_ms"):
        pass
    assert opened == []
    assert 4.0 <= first and first + 2.0 <= row["codec_ms"] < 1e3
    assert set(row) == {"codec_ms", "h2d_host_ms"}
    assert 0.0 <= row["h2d_host_ms"] < 1e3
    # under a profiler the same call opens its range, and the row still
    # takes its milliseconds
    with profile(activities=[ProfilerActivity.CPU]):
        with span("apa.codec", row):
            pass
    assert opened == ["apa.codec"]


def test_span_adds_its_milliseconds_when_the_block_raises():
    row = {}
    with pytest.raises(ValueError):
        with span("apa.fetch", row):
            raise ValueError("no hits")
    assert row["fetch_ms"] >= 0.0


def test_profiler_trace_names_every_stage_inside_the_caller(tmp_path):
    app = APAReadoutApp(n_links=L, device="cpu", pipelined=True, **PROD)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for frames in batches(2):
            with record_function("caller.step"):
                app.process_batch(frames)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    callers = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e["name"] == "caller.step"]
    assert len(callers) == 2
    found = {}
    for e in events:
        if e["name"].startswith("apa."):
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            assert any(a <= s and t <= b for a, b in callers), e["name"]
            found[e["name"]] = found.get(e["name"], 0) + 1
    # two submits, one finish (the second batch is still in flight); the
    # words span once a submit: the time2 feed reads the frames in place,
    # so no words page is made and none released
    want = {name: 2 for name in SPANS}
    want.update({"apa.fetch": 1, "apa.assembly": 1, "apa.handler": 1})
    assert found == want


def test_the_app_opens_no_range_after_the_profiler(monkeypatch):
    """Once a capture has ended, the app's spans open no range: the
    enabled check is read at each span, not once."""
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: opened.append(name) or real(name))
    with profile(activities=[ProfilerActivity.CPU]):
        with span("apa.codec", {}):
            pass
    assert opened == ["apa.codec"]
    assert len(run_app(2, pipelined=True)) == 2
    assert opened == ["apa.codec"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_rows_hold_the_host_stages_and_no_device_keys(pipelined):
    rows = run_app(3, pipelined)
    assert len(rows) == 3
    for row in rows:
        assert set(row) == set(SPANS.values()) | {"step_ms", "total_ms"}
        assert all(v >= 0.0 for v in row.values())
        assert "device_ms" not in row
        assert not [k for k in row if k.endswith("_device_ms")]


@pytest.mark.parametrize("pipelined", [False, True])
def test_spans_fit_inside_the_step(pipelined):
    """Per row the named spans sum to no more than ``step_ms``, and the
    step to no more than ``total_ms``; unpipelined the step is the call."""
    rows = run_app(4, pipelined)
    for row in rows:
        named = sum(row[k] for k in SPANS.values())
        assert 0.0 < named <= row["step_ms"] + ROUNDING_MS
        assert row["step_ms"] <= row["total_ms"] + ROUNDING_MS
        if not pipelined:
            assert row["total_ms"] - row["step_ms"] < 1.0


def test_latency_info_lists_the_stages_without_the_step():
    app = APAReadoutApp(n_links=L, device="cpu", **PROD)
    for frames in batches(2):
        app.process_batch(frames)
    info = app.latency_info(frames_per_batch=N)
    assert set(info["stages_ms_p50"]) == set(SPANS.values())
    assert info["proc_ms_p95"] >= info["proc_ms_p50"] > 0


def test_logging_keeps_its_taxonomy_and_traces_and_drops_timed():
    assert not hasattr(tlog, "timed")
    assert (tlog.TLVL_HOUSEKEEPING, tlog.TLVL_FRAME_RECEIVED) == (11, 15)
    for name in ("tlog", "device_trace", "trace_counts", "device_records"):
        assert callable(getattr(tlog, name))
