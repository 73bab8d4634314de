"""The ProtoWIB processor's stage spans and counters on the CPU: each
``process`` call appends one ``batch_timings`` row of the eight host spans
and ``total_ms`` (no device key off a card), the spans fit inside the
call's wall, the history is bounded, every ``protowib.*`` stage is a
profiler range inside the caller's, and ``get_info()`` counts two TPG
launches a call, the feed's bytes and the TPSets sent.  The APA app's rows
are held by ``tests/test_torch_spans.py``."""

import json
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fdreadoutlibs_tpu_torch import native
from fdreadoutlibs_tpu_torch.formats import protowib
from fdreadoutlibs_tpu_torch.stream import WIBFrameProcessor
from fdreadoutlibs_tpu_torch.stream.protowib import SPAN_KEYS, TPG_COUNTS
from fdreadoutlibs_tpu_torch.testing import protowib_superchunks
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler

torch.set_num_threads(1)

SC, CALLS = 8, 3
T = SC * protowib.FRAMES_PER_SUPERCHUNK
# range name -> row key
SPANS = {"protowib.checks": "checks_ms", "protowib.codec": "codec_ms",
         "protowib.h2d": "h2d_host_ms", "protowib.tpg": "tpg_launch_ms",
         "protowib.compact": "compact_launch_ms",
         "protowib.fetch": "fetch_ms", "protowib.emit": "assembly_ms",
         "protowib.handler": "handler_ms"}
ROUNDING_MS = 1e-6
FEEDS = ("time2", "packed")


class Sink:
    def __init__(self):
        self.sets = []

    def try_send(self, s):
        self.sets.append(s)
        return True


def make(feed, sink=None):
    p = WIBFrameProcessor(tp_handler=WIBTPHandler(
        tpset_sink=sink, tp_timeout=T * 25, tpset_window_size=500),
        device="cpu")
    p.conf({"enable_tpg": True, "tpg_backend": "pallas",
            "tpg_time2_feed": feed == "time2"})
    p.start()
    return p


def batches(n=CALLS):
    sc, _ = protowib_superchunks(1, n * SC, seed=23, n_pulses=40)
    return [sc[0, b * SC:(b + 1) * SC].copy() for b in range(n)]


def test_the_span_keys_are_the_stage_keys():
    assert set(SPAN_KEYS) == set(SPANS.values())


@pytest.mark.parametrize("feed", FEEDS)
def test_rows_hold_the_spans_and_no_device_keys(feed):
    p = make(feed)
    for b in batches():
        p.process(b)
    rows = list(p.batch_timings)
    assert len(rows) == CALLS
    for row in rows:
        assert set(row) == set(SPANS.values()) | {"total_ms"}
        assert all(v >= 0.0 for v in row.values())
        assert row["codec_ms"] > 0 and row["tpg_launch_ms"] > 0
        assert row["fetch_ms"] > 0 and row["checks_ms"] > 0
        named = sum(row[k] for k in SPANS.values())
        assert named <= row["total_ms"] + ROUNDING_MS


def test_history_is_bounded_and_restarts():
    p = make("time2")
    assert isinstance(p.batch_timings, deque)
    assert p.batch_timings.maxlen == 4096
    p.batch_timings = deque(maxlen=2)
    for b in batches():
        p.process(b)
    assert len(p.batch_timings) == 2
    p.start()
    assert len(p.batch_timings) == 0


@pytest.mark.parametrize("feed", FEEDS)
def test_info_counts_launches_bytes_and_tpsets(feed):
    sink = Sink()
    p = make(feed, sink)
    for b in batches():
        p.process(b)
    info = p.get_info()
    assert info["tpg_launches"] == 2 * CALLS
    if feed == "time2":
        per_call = sum(4 * int(np.prod(native.time2_feed_shape(
            1, T, ch_per_link=C, pad8=False)))
            for C in (protowib.N_COLLECTION, protowib.N_INDUCTION))
    else:
        per_call = T * protowib.FRAME_SIZE
    assert info["h2d_bytes"] == CALLS * per_call
    assert info["tpsets_sent"] == len(sink.sets) > 0
    assert info["num_hits_dropped_collection"] \
        + info["num_hits_dropped_induction"] \
        == info.get("num_hits_dropped", 0)
    # the counters the JAX processor shares hold none of these
    assert not set(TPG_COUNTS) & set(p.metrics.get_info())
    assert set(TPG_COUNTS) <= set(info)


def test_profiler_names_every_stage_inside_the_caller(tmp_path):
    p = make("time2")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches(2):
            with record_function("caller.step"):
                p.process(b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    callers = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e["name"] == "caller.step"]
    assert len(callers) == 2
    found = {}
    for e in events:
        if e["name"].startswith("protowib."):
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            assert any(a <= s and t <= b for a, b in callers), e["name"]
            found[e["name"]] = found.get(e["name"], 0) + 1
    assert set(found) == set(SPANS)
    # a codec, copy and launch a plane, one compaction and one fetch span
    # a call
    assert found["protowib.codec"] == found["protowib.tpg"] == 4
    assert found["protowib.compact"] == found["protowib.fetch"] == 2
