"""Per-frontend kernel-chain RTF arms: every frontend with a device path
gets its own real-time factor at a production aggregation.

Counterpart of ``scripts/bench_frontends.py`` (``_noise_pulses`` :68-75,
the arms :109-322, ``run_all`` :329-341), on the port's entries:

* ``wib2`` — 10 links x 256 channels, FIR 5 without peaks, the time2 host
  feed (``native.relayout_time2(ch_per_link=256)`` -> K3 on time2 rows)
  and, as ``rtf_fused``, the packed words through
  ``ingest.process_packed_wib2`` (device unpack -> K3).  A tick is 32
  clocks at 62.5 MHz.
* ``protowib`` — 10 links, FIR 5 on both planes (960 collection and 1600
  induction channels), time2 feeds (K3).  A tick is 25 clocks at 50 MHz.
* ``daphne_stream`` — 10 links x 4 channels, SimpleThreshold 50, the
  packed stream words through ``ingest.process_packed_daphne`` (device
  unpack -> K2).  One clock per sample (62.5 MHz a channel): the serial
  recurrence bounds the time per tick at any channel count.
* ``tde`` — 40 links x 64 channels, SimpleThreshold 500, resident plain
  windows (K2).  Samples are 32 clocks apart.

Each arm runs a chain of ``n_windows`` windows carrying state on resident
inputs, checks that the chain closed at least 3 hits, and times ``trials``
chains with CUDA events (``bench.time_chain``).  Those events also hold the
card's idle time between launches; ``daphne_stream``, a chain of many
short launches, also reports one traced chain (``device_trace``): the
device's busy and idle time per window and its busy share.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .. import native
from ..formats import daphne, protowib, tde, wib2
from ..formats.bitpack import pack_14bit
from ..ops import TPGConfig, ingest, tpg
from ..utils.logging import TRACE_FILE, device_trace
from ..utils.tuning import kernel_knobs
from . import seeded_state, time2_words, time_chain

TICK_HZ = {
    "wib2": 62.5e6 / 32,
    "protowib": 50e6 / 25,
    "daphne_stream": 62.5e6,
    "tde": 62.5e6 / 32,
}


def _noise_pulses(T, C, seed, sigma=30, base=900, n_sig=None, amp_lo=300,
                  amp_hi=3000):
    rng = np.random.default_rng(seed)
    adcs = (base + rng.normal(0, sigma, size=(T, C))).astype(np.int32)
    for _ in range(n_sig if n_sig is not None else max(20, C // 16)):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(amp_lo, amp_hi)
    return adcs


def _knobs(cfg: TPGConfig, T: int) -> dict:
    """The family's knobs, its tc 256 where the tuned one does not divide
    the window (bench_frontends.py:133)."""
    k = kernel_knobs(cfg)
    if T % k["tc"]:
        k["tc"] = 256
    return k


def _measure(step, state0, n_windows, span_s, trials, device, sanity):
    """Check the chain's hits, then time it: (median RTF, per-trial RTFs,
    lowest first).  ``step(state) -> (closes, state)``."""
    s, closes = state0, 0
    for _ in range(n_windows):
        n, s = step(s)
        closes += int(n)
    if closes < sanity:
        raise AssertionError(f"hit path produced only {closes} hits")
    per = time_chain(lambda s, i: step(s)[1], state0, n_windows, trials,
                     device)
    return span_s / float(np.median(per)), sorted(span_s / d for d in per)


# captures a traced chain takes at most: CUPTI now and then delivers one
# short of its device records (``probes/trace_capture.py``)
TRACE_CAPTURES = 3
# the trace's device records and the runtime calls that launch them
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def chain_trace(step, state0, n_windows: int, device) -> dict | None:
    """One chain of ``n_windows`` windows under ``utils.logging.
    device_trace``: per window, the kernel launches, the device's busy time
    (the union of its kernel, copy and set records) and its idle time over
    the span from the first record's start to the last one's end, and the
    busy share of that span.  A capture with fewer kernel records than
    launch calls is taken again, up to ``TRACE_CAPTURES`` in all; the last
    one is read.  None on the CPU (no device records)."""
    if torch.device(device).type != "cuda":
        return None
    for capture in range(1, TRACE_CAPTURES + 1):
        with tempfile.TemporaryDirectory() as d:
            with device_trace(d):
                s = state0
                for _ in range(n_windows):
                    s = step(s)[1]
            with open(os.path.join(d, TRACE_FILE)) as f:
                events = [ev for ev in json.load(f).get("traceEvents", [])
                          if ev.get("ph") == "X"]
        recs = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                      for ev in events if ev.get("cat") in _DEVICE_CATS)
        kernels = sum(ev.get("cat") == "kernel" for ev in events)
        launched = sum(str(ev.get("name", "")).startswith(
            ("cudaLaunch", "cuLaunch")) for ev in events)
        if recs and kernels == launched:
            break
    if not recs:
        raise AssertionError("the traced chain holds no device record")
    busy, end = 0.0, recs[0][0]
    for a, b in recs:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - recs[0][0]
    return {"captures": capture, "kernel_records": kernels,
            "launch_calls_per_window": round(launched / n_windows, 2),
            "device_busy_us_per_window": round(busy / n_windows, 3),
            "device_idle_us_per_window": round((span - busy) / n_windows, 3),
            "device_busy_share": round(busy / span, 4)}


def arm_wib2(T, n_windows, trials, device, links=10):
    C = links * wib2.N_CHANNELS
    cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    adcs = _noise_pulses(T, C, seed=11)
    # the wire words, per link: (L, T, 112) packed 14-bit rows
    words = np.stack([
        pack_14bit(adcs[:, l * 256:(l + 1) * 256].astype(np.uint16),
                   wib2.ADC_BITS, n_words=wib2.ADC_WORDS)
        for l in range(links)])
    k = _knobs(cfg, T)
    state0 = seeded_state(adcs, cfg.rs_memory_factor_x10, device)
    kw = dict(tc=k["tc"], k_slots=k["k_slots"], fir_twopass=k["fir_twopass"],
              geometry=k["geometry"])
    w = torch.from_numpy(words.view(np.int32)).to(device)
    # production path (stream/wib2.py tpg_time2_feed): the host unpacks and
    # pairs the ticks; its cost is the host_codecs cell's
    feed = torch.from_numpy(
        native.relayout_time2(words, ch_per_link=256, pad8=False)).to(device)

    def step_time2(s):
        _, nclose, s = ingest.process_time2_feed(feed, s, cfg, C, **kw)
        return nclose.sum(), s

    def step_fused(s):
        _, nclose, s = ingest.process_packed_wib2(w, s, cfg, C, **kw)
        return nclose.sum(), s

    span = T / TICK_HZ["wib2"]
    rtf, per = _measure(step_time2, state0, n_windows, span, trials, device,
                        sanity=3)
    rtf_f, per_f = _measure(step_fused, state0, n_windows, span, trials,
                            device, sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": C, "links": links, "algorithm": "FIR",
            "ingest": "time2 host feed (codec in host_codecs)",
            "rtf_fused": round(rtf_f, 2),
            "trials_fused": [round(v, 2) for v in per_f],
            "tick_hz": TICK_HZ["wib2"]}


def arm_protowib(T, n_windows, trials, device, links=10):
    cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    k = _knobs(cfg, T)
    kw = dict(tc=k["tc"], k_slots=k["k_slots"], fir_twopass=k["fir_twopass"],
              geometry=k["geometry"])
    planes = []
    for per_link, seed in ((protowib.N_COLLECTION, 13),
                           (protowib.N_INDUCTION, 17)):
        C = links * per_link
        adcs = _noise_pulses(T, C, seed=seed)
        planes.append((C, time2_words(torch.from_numpy(adcs).to(device)),
                       seeded_state(adcs, cfg.rs_memory_factor_x10, device)))

    def step(states):
        closes, out = 0, []
        for (C, feed, _), s in zip(planes, states):
            _, nclose, s = ingest.process_time2_feed(feed, s, cfg, C, **kw)
            closes = closes + nclose.sum()
            out.append(s)
        return closes, tuple(out)

    span = T / TICK_HZ["protowib"]
    rtf, per = _measure(step, tuple(p[2] for p in planes), n_windows, span,
                        trials, device, sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": links * 256, "links": links,
            "algorithm": "FIR dual-plane",
            "ingest": "time2 host feed (codec in host_codecs)",
            "tick_hz": TICK_HZ["protowib"]}


def arm_daphne_stream(T, n_windows, trials, device, links=10):
    C = links * daphne.STREAM_N_CHANNELS
    N = T // daphne.STREAM_N_SAMPLES
    cfg = TPGConfig.from_raw("SimpleThreshold", threshold=50)
    adcs = _noise_pulses(T, C, seed=19, sigma=8, base=8000, n_sig=60,
                         amp_lo=100, amp_hi=1500)
    # the stream's wire words: each frame is 64 ticks of 4 channels
    per_frame = adcs.reshape(N, daphne.STREAM_N_SAMPLES, links,
                             daphne.STREAM_N_CHANNELS).transpose(2, 0, 1, 3)
    flat = per_frame.reshape(links, N, daphne.STREAM_N_SAMPLES *
                             daphne.STREAM_N_CHANNELS).astype(np.uint16)
    words = pack_14bit(flat, daphne.ADC_BITS, n_words=daphne.STREAM_ADC_WORDS)
    k = _knobs(cfg, T)
    state0 = seeded_state(adcs, cfg.rs_memory_factor_x10, device)
    w = torch.from_numpy(words.view(np.int32)).to(device)

    def step(s):
        _, nclose, s = ingest.process_packed_daphne(
            w, s, cfg, C, tc=k["tc"], k_slots=k["k_slots"],
            geometry=k["geometry"])
        return nclose.sum(), s

    span = T / TICK_HZ["daphne_stream"]
    rtf, per = _measure(step, state0, n_windows, span, trials, device,
                        sanity=3)
    return {"rtf": round(rtf, 3), "trials": [round(v, 3) for v in per],
            "trace": chain_trace(step, state0, n_windows, device),
            "channels": C, "links": links, "algorithm": "SimpleThreshold",
            "ingest": "fused on-device 14-bit unpack",
            "tick_hz": TICK_HZ["daphne_stream"],
            "per_tick_wall_ns": round((span / rtf) / T * 1e9, 1),
            "note": "62.5 MHz/channel stream; serial recurrence bounds "
                    "per-tick wall, so chips_per_stream = 1/rtf at any "
                    "channel count"}


def arm_tde(T, n_windows, trials, device, links=40):
    C = links * tde.N_CHANNELS_PER_LINK
    cfg = TPGConfig.from_raw("SimpleThreshold", threshold=500)
    adcs = _noise_pulses(T, C, seed=23, amp_lo=600, amp_hi=3000)
    k = _knobs(cfg, T)
    state0 = seeded_state(adcs, cfg.rs_memory_factor_x10, device)
    feed = torch.from_numpy(adcs).to(device)

    def step(s):
        _, nclose, s = tpg.process_window(
            feed, s, cfg, k["tc"], k["k_slots"], time_packed=False,
            geometry=k["geometry"])
        return nclose.sum(), s

    span = T / TICK_HZ["tde"]
    rtf, per = _measure(step, state0, n_windows, span, trials, device,
                        sanity=3)
    return {"rtf": round(rtf, 2), "trials": [round(v, 2) for v in per],
            "channels": C, "links": links, "algorithm": "SimpleThreshold",
            "ingest": "resident windows (TDE host decode is a uint16 "
                      "view+transpose, not a codec)",
            "tick_hz": TICK_HZ["tde"]}


ARMS = {"wib2": arm_wib2, "protowib": arm_protowib,
        "daphne_stream": arm_daphne_stream, "tde": arm_tde}


def run_all(T: int = 8192, n_windows: int = 16, trials: int = 3,
            device="cuda") -> dict:
    """{arm: its cell}, or {arm: {"error": message}} for an arm that raised
    (the others keep their numbers; the bench exits non-zero)."""
    from . import error_text
    device = torch.device(device)
    out = {}
    for name in ARMS:
        try:
            out[name] = ARMS[name](T, n_windows, trials, device)
        except Exception as e:  # noqa: BLE001 — isolate the arms
            out[name] = {"error": error_text(e)}
    return out
