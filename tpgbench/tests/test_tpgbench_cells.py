"""Every cell end to end at a cut size through the port's CPU plain path,
with a contract-shaped result; the comparison failing the control and
every fault a cell can have; the command's refusals."""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpgbench import harness, judge, spec
from tpgbench.systems import apa_app
from tpgbench.control import CONTROL_MASK

from conftest import CUT, ROOT

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = 4.0


def run(cell, seed=2**31 + 17, trace=0, seconds=SECONDS, **overrides):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.run_cell(BENCH, args, torch.device("cpu"),
                            time.monotonic(), dict(CUT, **overrides))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_line(cell):
    res = run(cell)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    json.dumps(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 4
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
    assert set(res["metrics"]) == want == {"rtf", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert harness.banned_modules() == []


@pytest.mark.parametrize("key, value", [
    ("feed", "fused"), ("pipelined", False), ("tc", 128),
    ("rs_scale_factor_x10", 4), ("accumulator_limit", 9),
    ("tp_timeout", 50_000), ("tpset_min_latency_ticks", 40960),
    ("tpset_transmission_rate_hz", 500)])
def test_configuration_states_what_the_app_runs(key, value):
    """A configuration that states a setting the app does not run is
    refused before any batch, not run and then found incorrect."""
    with pytest.raises((ValueError, RuntimeError), match=key):
        harness.Run(BENCH, CELLS[0], 5, torch.device("cpu"),
                    dict(CUT, **{key: value}))


def test_window_keeps_a_bounded_sample(monkeypatch):
    """The runs the comparison follows are drawn over the whole window
    while it passes; the states and sets kept stay few.  (Fewer runs and
    a shorter memory than the cell's, for a window of 40 batches.)"""
    monkeypatch.setattr(apa_app, "DRAWN_RUNS", 2)
    monkeypatch.setattr(apa_app, "KEEP_BACK", 4)
    r = harness.Run(BENCH, CELLS[0], 41, torch.device("cpu"), CUT)
    r.warm()
    system = r.system
    system.start_window(41)
    for _ in range(40):
        system.step()
    system.stop_window()
    lo, hi = system.window
    assert hi - lo > 4 * apa_app.DRAWN_RUNS
    runs = system.runs()
    assert runs[0] == 0 and runs[-1] == hi - 2
    assert len(system.drawn) == apa_app.DRAWN_RUNS
    assert all(lo <= b <= hi - 2 for b in system.drawn)
    bound = apa_app.KEEP_BACK + 1 + (apa_app.DRAWN_RUNS + 2) * (
        apa_app.RUN_BATCHES + 2)
    assert len(system.states) <= bound and len(system.sets) <= bound
    assert hi > bound
    system.finish()
    assert judge.correct(system.judge())


def test_reservoir_draws_from_the_seed_over_the_whole_stream():
    def draw(seed, n=2000):
        s = apa_app.System.__new__(apa_app.System)
        s.drawn = []
        s.rng, s.offered = np.random.default_rng([seed, 1]), 0
        for b0 in range(n):
            s._offer(b0)
        return sorted(s.drawn)
    a = draw(7)
    assert a == draw(7) and a != draw(8)
    assert len(a) == apa_app.DRAWN_RUNS and a[-1] >= 1000 and a[0] < 1000


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    r = harness.Run(BENCH, cell, 23, torch.device("cpu"), CUT)
    r.warm()
    r.window(SECONDS)
    r.system.finish()
    assert judge.correct(r.system.judge())
    ctrl = r.system.judge(r.system.control_outputs(CONTROL_MASK))
    assert not judge.correct(ctrl)


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


# the timed path's entries: the kernel's launch and the compact-hit fetch
KERNEL = ("fdreadoutlibs_tpu_torch.apps.apa_readout", "process_time2_feed")
FETCH = ("fdreadoutlibs_tpu_torch.apps.apa_readout", "unpack_compact")
FAULTS = {"state_unchanged": (KERNEL, _state_unchanged),
          "half_left_out": (KERNEL, _half_left_out),
          "answer_altered": (FETCH, _answer_altered)}


def _now_and_then(wrap, every=7):
    """``wrap``'s fault in one call of ``every``, none in the others."""
    def outer(orig):
        faulty, n = wrap(orig), [0]
        def f(*a, **kw):
            n[0] += 1
            return (faulty if n[0] % every == 0 else orig)(*a, **kw)
        return f
    return outer


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(monkeypatch, cell, fault, sparse):
    """Each fault, in every batch or in one batch of seven, reads
    ``correct`` false."""
    import importlib
    (mod, name), wrap = FAULTS[fault]
    m = importlib.import_module(mod)
    if sparse:
        wrap = _now_and_then(wrap)
    monkeypatch.setattr(m, name, wrap(getattr(m, name)))
    # busy enough that every batch's fault changes what it delivers, and
    # a window long enough to hold the seventh batch and later ones
    res = run(cell, seconds=3 * SECONDS if sparse else SECONDS,
              pulse_rate_per_channel_frame=0.05)
    assert res["correct"] is False, res["checks"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "-m", "tpgbench", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_outside_a_checkout(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the port is missing: no result, a nonzero exit."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tpgbench", tmp_path / "tpgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "tpgbench", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "tpgbench", "--workload", cell,
                        "--seed", "3000000099", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
