"""The facts of a frontend come from the system module a configuration
names, not from the harness: the WIBEth cell's readings are the formulas
they always were, to the last bit; a stub module of another frontend sets
``batch_s`` and the roofline's least bytes through the harness unchanged;
the trace counts the kernel records a batch."""

import ast
import types

import pytest
import torch

from tpgbench import harness, spec, trace
from tpgbench.systems import apa_app

BENCH = spec.load_benchmark()
CELL = "hd_apa_wibeth.nominal"

# fixed records of the WIBEth cell: delivered, window_s, kernel_s, hits,
# batches of the traced segment
RECORDS = [(600, 51.00312, 0.03471, 52311, 48),
           (1217, 51.0000417, 0.0338229, 49870, 48),
           (3, 2.5, 0.001, 0, 4)]


def wibeth_record(delivered, window_s, kernel_s, hits, batches):
    cfg, tr = spec.configuration(BENCH, "hd_apa_wibeth"), \
        spec.traffic("nominal")
    assert (cfg["links"], tr["frames_per_batch"]) == (40, 128)
    return {"config": cfg, "traffic": tr, "apas": 1,
            "batch_s": apa_app.batch_seconds(cfg, tr),
            "delivered": delivered, "window_s": window_s,
            "trace": {"busy_s": 1.0, "batches": batches,
                      "kernel_s": kernel_s, "hits": hits,
                      "least_bytes": apa_app.least_bytes(cfg, tr,
                                                         hits / batches)}}


@pytest.mark.parametrize("rec", RECORDS)
def test_wibeth_readings_are_the_parents_formulas(rec):
    delivered, window_s, kernel_s, hits, batches = rec
    run = wibeth_record(*rec)
    # the harness's formulas before the frontend's facts left it
    batch_s = 128 * 2048 / 62.5e6
    assert run["batch_s"] == batch_s == 0.004194304
    rtf = delivered * batch_s / 1 / window_s
    channels, ticks = 40 * 64, 128 * 64
    least = (channels * ticks * 14 / 8 + channels * (10 + 9) * 2
             + hits / batches * 24) / 3.35e12
    share = 100.0 * least * 1e3 / (kernel_s * 1e3 / batches)
    assert spec.reader("rtf")(run) == rtf
    assert spec.reader("tpg_roofline_share")(run) == share
    assert channels * ticks * 14 / 8 + channels * 19 * 2 == 36_797_440


def test_roofline_share_silent_without_least_bytes():
    run = wibeth_record(*RECORDS[0])
    del run["trace"]["least_bytes"]
    assert spec.reader("tpg_roofline_share")(run) is None
    assert spec.reader("tpg_roofline_share")({"trace": None}) is None


STUB_BYTES = 7.25e6


def stub_module(calls):
    """A frontend of 8208 frames a batch, 25 clocks a frame at 50 MHz, whose
    least bytes are a fixed count plus 10 a hit."""
    class System:
        def __init__(self, config, traffic, source, device):
            self.b = 0

        def step(self):
            self.b += 1
            return [(0, self.b - 1)]

        def start_window(self, seed):
            self.b0 = self.b

        def stop_window(self):
            return [(0, b) for b in range(self.b0, self.b)]

        def layer_record(self):
            return {}

        def hits_total(self):
            return 7 * self.b

        def finish(self):
            pass

    def least_bytes(config, traffic, hits_per_batch):
        calls.append(hits_per_batch)
        return STUB_BYTES + 10 * hits_per_batch

    return types.SimpleNamespace(
        n_apas=lambda config: 1, min_ring=lambda config, traffic: 1,
        batch_seconds=lambda config, traffic: 8208 * 25 / 50e6,
        least_bytes=least_bytes, System=System)


def test_a_stub_frontend_sets_batch_s_and_least_bytes(monkeypatch):
    calls = []
    monkeypatch.setattr(spec, "system", lambda name: stub_module(calls))
    monkeypatch.setattr(spec, "generator", lambda name: types.SimpleNamespace(
        Source=lambda *a: types.SimpleNamespace(N=8208)))
    traced = {"busy_s": 0.5, "window_s": 1.0, "kernel_s": 0.012,
              "h2d_s": 0.0, "kernels": 96, "device_ops": [],
              "idle_gaps": []}
    monkeypatch.setattr(trace, "capture", lambda steps, step: [
        step() for _ in range(steps)])
    monkeypatch.setattr(trace, "reduce", lambda cap: dict(traced))
    r = harness.Run(BENCH, CELL, 5, torch.device("cpu"))
    assert r.batch_s == 0.004104
    r.warm()
    r.window(0.01)
    r.traced(steps=4)
    assert calls == [7.0]
    assert r.trace["least_bytes"] == STUB_BYTES + 70
    rec = r.record()
    least = (STUB_BYTES + 70) / 3.35e12
    assert spec.reader("tpg_roofline_share")(rec) == \
        100.0 * least * 1e3 / (0.012 * 1e3 / 4)
    assert spec.reader("rtf")(rec) == \
        len(r.deliveries) * 0.004104 / 1 / r.window_s
    assert spec.reader("launches_per_batch")(rec) == 24.0


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_launches_count_kernel_records_not_copies_or_memsets():
    events = [event(trace.SEGMENT, "user_annotation", 1000.0, 9000.0),
              event("process_batch", "cpu_op", 1100.0, 8000.0),
              # before the segment: not counted
              event("pipe_kernel", "kernel", 900.0, 50.0),
              event("Memcpy HtoD", "gpu_memcpy", 1200.0, 300.0),
              event("Memset (Device)", "gpu_memset", 1550.0, 5.0),
              event("pipe_kernel", "kernel", 1600.0, 20.0),
              event("computeDigitCumSum", "kernel", 1650.0, 4.0),
              event("Memcpy DtoH", "gpu_memcpy", 1700.0, 10.0),
              event("scatter_gather", "kernel", 1720.0, 0.0),
              event("pipe_kernel", "kernel", 5600.0, 20.0),
              event("Memcpy HtoD", "gpu_memcpy", 5200.0, 300.0)]
    tr = trace.reduce({"events": events})
    assert tr["kernels"] == 4
    tr["batches"] = 2
    run = {"trace": tr}
    assert spec.reader("launches_per_batch")(run) == 2.0
    # a capture of copies alone reads no launches: zero, not silence,
    # while the device was busy
    copies = [e for e in events if e["cat"] != "kernel"]
    tr = dict(trace.reduce({"events": copies}), batches=2)
    assert tr["kernels"] == 0
    assert spec.reader("launches_per_batch")({"trace": tr}) == 0.0


@pytest.mark.parametrize("run", [
    {"trace": None}, {},
    {"trace": {"batches": 48, "busy_s": 0.2, "kernel_s": 0.01}},
    {"trace": {"batches": 0, "busy_s": 0.2, "kernels": 10}},
    {"trace": {"batches": 48, "busy_s": 0.0, "kernels": 0}}])
def test_launches_silent_without_a_device_trace(run):
    assert spec.reader("launches_per_batch")(run) is None


def test_harness_holds_no_frontend_fact():
    """The harness imports no frame format and names no clock."""
    src = (spec.PKG / "harness.py").read_text()
    imported = {n.module for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.split(".")[0] in ("reference", "generators")
                   for m in imported), imported
    assert "CLOCK" not in src and "frames" not in src


def test_launches_entry_reads_every_cell():
    m = {m["name"]: m for m in BENCH["per_layer"]}["launches_per_batch"]
    assert "workloads" not in m
    assert (m["source"], m["moves"], m["layer"]) == \
        ("device_trace", "rtf", "TPG kernel and compaction")
    assert "launches_per_batch" in {
        x["name"] for x in spec.metrics_of(BENCH, CELL, True)}
