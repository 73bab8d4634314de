#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. device  — requires a CUDA card of capability (9, 0); prints its name and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build   — compiles ``fdreadoutlibs_tpu_torch/csrc/tpg.cu`` with nvcc and
   summarizes ``ptxas -v`` (registers, stack, spills);
3. kernel  — the hand-written kernel against its plain PyTorch version on
   the card at T=8192 ticks x 2560 channels (tc=256, K=4): K1 (time2
   datapath) and K2 (plain-sample datapath) for SimpleThreshold, AbsRS and
   StandardRS, K3 (FIR, threshold 5) on both datapaths with and without
   peak tracking.  Slots, nclose and state must be bit-equal and some
   chunk must close more than K hits (drops exercised); both are timed.
   K4 (the in-kernel 14-bit unpack) takes the same ADCs packed as frame
   words (L, T, 28) and as words14 rows (T, WR, 7, 128) for the four
   families: the torch unpack of each must give back the ADCs, so K4's
   plain version is the plain result of K2 (K3 for FIR) on them, and K4's
   slots, nclose and state must equal it bit for bit;
4. apa slice — the production APA app (40 WIBEth links, AbsRS,
   threshold-on-collection) on each of its four feeds: time2 (host codec,
   K1), fused (frame words, K4), words14 (host relayout, K4) and packed
   (device unpack, K2).  Per feed: one warm-up batch of 128 frames per link
   (timed apart, as set-up), a steady window of 16 batches for the
   end-to-end RTF and ``latency_info``, the feed's kernel launched once per
   batch, the first 2 batches' hits equal to one shared plain result (the
   kernel's plain version plus the same compaction on the same ADCs), and
   a per-stage split of one batch;
5. wib2 slice — 10 WIB2 links (2560 channels) through 10 per-link
   ``WIB2FrameProcessor``s, FIR threshold 5, batches of 512 superchunks
   per link (T = 6144 ticks = 3.146 ms), once with the packed ingest (device
   unpack, K2 + K3) and once with the time2 feed (host codec, K3): one
   warm-up batch, 8 steady batches (end-to-end RTF, ms per batch), one
   launch per link per batch, TPs sent and no timestamp errors, batches
   0-1 of every link equal to the plain version with the processors'
   seeding, tc and compaction; then a per-stage split of one batch.

The last lines are the card's name and power limit, one JSON object with
the kernels, and the result line ``{"ok": true, "device": {...}}``.
Imports only ``torch``, numpy and the port.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.formats import wib2, wibeth
from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, _build,
                                         ingest, init_chanstate,
                                         seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.ops.ingest import (compact_on_device,
                                                unpack_compact)
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream,
                                             wib2_superchunks)
from fdreadoutlibs_tpu_torch.utils.tuning import kernel_knobs

N_LINKS = 40                 # one APA
C_APA = N_LINKS * 64         # 2560 channels
T_APA = 8192                 # ticks per APA batch (128 frames)
TC, K = 256, 4
FRAMES = 128
N_WARM, N_TIMED, N_CHECKED = 1, 16, 2
SEED = 20260
# the APA app's feeds: constructor flags and the kernel each launches
APP_FEEDS = {"time2": ({"time2_feed": True}, "K1"),
             "fused": ({"fused_unpack": True}, "K4"),
             "words14": ({"words14_feed": True}, "K4"),
             "packed": ({}, "K2")}

WIB2_LINKS = 10              # 10 x 256 = 2560 channels
WIB2_SC = 512                # superchunks per link per batch
WIB2_T = WIB2_SC * wib2.FRAMES_PER_SUPERCHUNK      # 6144 ticks
WIB2_TICK_S = 32 / 62.5e6    # 512 ns
WIB2_TIMED = 8

REPLACES = {"K1": "fdreadoutlibs_tpu/ops/pallas_tpg.py:439",
            "K2": "fdreadoutlibs_tpu/ops/pallas_tpg.py:399",
            "K3": "fdreadoutlibs_tpu/ops/pallas_tpg.py:464",
            "K4": "fdreadoutlibs_tpu/ops/pallas_tpg.py:241"}
SOURCE = "fdreadoutlibs_tpu_torch/csrc/tpg.cu"


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[{name}] start", flush=True)

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                print(f"[{name}] ok in {time.perf_counter() - self.t0:.3f} s",
                      flush=True)
    return _Phase()


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_kernel(fn, n: int, flush: torch.Tensor) -> float:
    """Mean ms per call over n calls, each after an L2 flush (the kernel
    reads a feed that was just copied in, not a warm cache)."""
    fn()
    ms = 0.0
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms += a.elapsed_time(b)
    return ms / n


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    stack = [int(s) for s in re.findall(r"(\d+) bytes stack frame", log)]
    spill = [int(s) for s in re.findall(r"(\d+) bytes spill", log)]
    return (f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"stack frame max {max(stack)} B, spills max {max(spill)} B")


def plain_app_hits(adcs_batches, rmf, cfg, k_slots: int, dev):
    """What the APA app must fetch for consecutive batches of (T, C) ADCs:
    the kernel's plain version, with the app's state seeding, chunking and
    compaction, carrying state across batches.  Yields (hits, dropped)."""
    state = None
    for adcs in adcs_batches:
        T, C = adcs.shape
        if state is None:
            state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0],
                                                  rmf), C, device=dev)
        tc = tpg.auto_tc(T, cap=kernel_knobs(cfg)["tc"])
        feed = torch.from_numpy(time2_words(adcs)).to(dev)
        slots, nclose, state = tpg.process_window_plain(feed, state, cfg,
                                                        tc, k_slots)
        yield unpack_compact(compact_on_device(slots, nclose, 0, C,
                                               max(2048, 2 * C)))


def plain_processor_hits(adcs_batches, procs, time2: bool, dev):
    """What the per-link WIB2 processors must fetch for consecutive batches
    of (L, T, 256) ADCs: the kernel's plain version over all links' channels
    at once (channels are independent), on the processors' datapath, with
    their seeding, tc, K and compaction per link, carrying state.  Yields
    per batch a list of (hits, dropped) per link."""
    p0 = procs[0]
    C = p0.N_CHANNELS
    L = len(procs)
    state = None
    for adcs in adcs_batches:
        T = adcs.shape[1]
        flat = adcs.transpose(1, 0, 2).reshape(T, L * C)
        if state is None:
            rmf = np.concatenate([p.register_memory_factor for p in procs])
            state = tpg.pack_state(seed_chanstate(
                init_chanstate(L * C), flat[0], rmf), L * C, device=dev)
        tc = tpg.auto_tc(T, cap=kernel_knobs(p0.tpg_cfg)["tc"])
        feed = torch.from_numpy(time2_words(flat) if time2 else flat).to(dev)
        slots, nclose, state = tpg.process_window_plain(
            feed, state, p0.tpg_cfg, tc, p0.k_slots, time_packed=time2)
        yield [unpack_compact(compact_on_device(
            slots[..., l * C:(l + 1) * C].contiguous(),
            nclose[:, l * C:(l + 1) * C].contiguous(), 0, C,
            max(2048, 2 * C))) for l in range(L)]


def check_equal(label: str, got, want) -> int:
    """Max |difference| of (slots, nclose, state); raises unless 0."""
    err = 0
    for g, w, what in zip(got, want, ("slots", "nclose", "state")):
        d = int((g.long() - w.long()).abs().max())
        err = max(err, d)
        if d:
            raise AssertionError(f"{label}: kernel {what} differs from "
                                 f"the plain version (max |d| {d})")
    return err


def check_strong(label: str, got) -> str:
    """Raise unless the window closed hits and overflowed K somewhere."""
    n_hits = int((got[0][:, :, -1] != 0).sum())
    n_over = int(got[1].max())
    if n_hits == 0 or n_over <= K:
        raise AssertionError(f"{label}: weak check ({n_hits} hits, max "
                             f"closes per chunk {n_over})")
    return f"{n_hits} hits, max {n_over} closes/chunk"


def kernel_vs_plain(dev):
    """Phase 3.  Returns {kernel: {"max_abs_err", "ms", "plain_ms",
    "timed"}} for the variant reported per kernel."""
    fir = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    thr = {"SimpleThreshold": TPGConfig(threshold=150),
           "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
           "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                   threshold=150)}
    cases = [("K1", f"{n} time2", c, True) for n, c in thr.items()] + \
        [("K2", f"{n} plain", c, False) for n, c in thr.items()] + \
        [("K3", "FIR time2", fir, True),
         ("K3", "FIR time2 peaks", replace(fir, track_peaks=True), True),
         ("K3", "FIR plain", fir, False),
         ("K3", "FIR plain peaks", replace(fir, track_peaks=True), False)]
    reported = {"K1": "AbsRS time2", "K2": "AbsRS plain", "K3": "FIR plain",
                "K4": "AbsRS frames"}
    adcs, rmf = tpg_stream(T_APA, C_APA, TC, K, SEED)
    fadcs = fir_stream(T_APA, C_APA, TC, K, SEED)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}
    plain = {}      # plain-datapath label -> (adcs, cfg, state, result)

    def record(kern, label, err, ms, plain_ms):
        prev = out.get(kern, {"max_abs_err": 0})
        entry = {"max_abs_err": max(prev["max_abs_err"], err)}
        if label == reported[kern]:
            entry.update(ms=ms, plain_ms=plain_ms, timed=label)
        out[kern] = {**prev, **entry}

    for kern, label, cfg, time2 in cases:
        a = fadcs if cfg.algorithm == Algorithm.FIR else adcs
        state = tpg.pack_state(seed_chanstate(init_chanstate(C_APA), a[0],
                                              rmf), C_APA, device=dev)
        feed = torch.from_numpy(time2_words(a) if time2 else a).to(dev)

        def run(feed=feed, state=state, cfg=cfg, time2=time2):
            return tpg.launch_kernel(feed, state, cfg, TC, K, time2)
        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = tpg.process_window_plain(feed, state, cfg, TC, K, time2)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = check_equal(label, got, want)
        what = check_strong(label, got)
        if not time2 and "peaks" not in label:
            plain[label] = (a, cfg, state, want)
        ms = time_kernel(run, 20, flush)
        print(f"  {kern} {label}: T={T_APA} x {C_APA} ch bit-equal ({what}); "
              f"kernel {ms:.4f} ms/batch, plain {plain_ms:.1f} ms/batch",
              flush=True)
        record(kern, label, err, ms, plain_ms)

    # K4: the same ADCs as packed words.  Its plain version is the torch
    # unpack and then K2's (K3's) plain loop: the unpack is checked equal to
    # the ADCs, so the plain result above is K4's; the reported case runs
    # the whole plain version again for its time.
    for fam, src in (("SimpleThreshold", "SimpleThreshold plain"),
                     ("AbsRS", "AbsRS plain"),
                     ("StandardRS", "StandardRS plain"), ("FIR", "FIR plain")):
        a, cfg, state, want = plain[src]
        frames = torch.from_numpy(frame_words(a).view(np.int32)).to(dev)
        a_dev = torch.from_numpy(a).to(dev)
        for layout, feed in (("frames", frames),
                             ("words14", ingest.pack_words14(frames))):
            label = f"{fam} {layout}"
            if not torch.equal(tpg.unpack_packed14(feed, layout, C_APA),
                               a_dev):
                raise AssertionError(f"{label}: the torch unpack does not "
                                     "give back the ADCs")

            def run(feed=feed, state=state, cfg=cfg, layout=layout):
                return tpg.launch_kernel(feed, state, cfg, TC, K, False,
                                         layout)
            got = run()
            torch.cuda.synchronize()
            plain_ms = None
            if label == reported["K4"]:
                t0 = time.perf_counter()
                want = tpg.process_window_plain(feed, state, cfg, TC, K,
                                                False, layout)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
            err = check_equal(label, got, want)
            what = check_strong(label, got)
            ms = time_kernel(run, 20, flush)
            print(f"  K4 {label} ({tuple(feed.shape)} int32): bit-equal "
                  f"({what}); kernel {ms:.4f} ms/batch"
                  + (f", plain {plain_ms:.1f} ms/batch" if plain_ms else ""),
                  flush=True)
            record("K4", label, err, ms, plain_ms)
    return out


def clock(fn):
    """(fn(), ms) with the device synced at the end."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def apa_stage_split(app, frames, feed: str, n_rep: int = 5):
    """One batch through the app's device seam one step at a time, each
    ended by a device sync: median ms per stage.  The app's carried state
    is left untouched."""
    L, N, _ = frames.shape
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    tc = tpg.auto_tc(T, cap=kernel_knobs(app.cfg)["tc"])
    reps = []
    for _ in range(n_rep):
        r = {}
        words, r["words copy"] = clock(lambda: wibeth.frames_bytes_to_u32(
            frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(L, T, 28))
        # the app's own host stage (a view for the fused and packed feeds)
        (host, _), r["codec"] = clock(lambda: app._host_feed(words))
        dev_in, r["H2D"] = clock(lambda: torch.from_numpy(host).to(
            app.device))
        if feed == "time2":
            kw = dict(feed=dev_in.reshape(T // 2, -1), time_packed=True)
        elif feed == "packed":
            kw = dict(time_packed=False)
            kw["feed"], r["device unpack"] = clock(
                lambda: wibeth.unpack_frames(dev_in.transpose(0, 1))
                .reshape(T, C))
        else:
            kw = dict(feed=dev_in, time_packed=False,
                      packed14="frames" if feed == "fused" else "words14")
        (slots, nclose, _), r["kernel"] = clock(lambda: tpg.process_window(
            state=app._state, cfg=app.cfg, tc=tc, k_slots=app.k_slots, **kw))
        packed, r["compaction"] = clock(lambda: compact_on_device(
            slots, nclose, 0, C, max(2048, 2 * C)))
        _, r["fetch"] = clock(lambda: unpack_compact(packed))
        reps.append(r)
    return {k: statistics.median(r[k] for r in reps) for k in reps[0]}


def apa_slice(dev) -> dict:
    """Phase 4.  Returns each feed's kernel launches in its app run."""
    rng = np.random.default_rng(SEED)
    ts, batches, checked_adcs = 0x1000000, [], []
    for b in range(N_WARM + N_TIMED):
        frames, adcs_b = make_batch(rng, N_LINKS, FRAMES, b, ts)
        batches.append(frames)
        if b < N_CHECKED:     # (L, N, 64 ticks, 64 ch) -> (T, C)
            checked_adcs.append(
                (adcs_b & 0x3FFF).transpose(1, 2, 0, 3)
                .reshape(FRAMES * 64, C_APA).astype(np.int32))
        ts += FRAMES * 2048
    data_seconds = N_TIMED * FRAMES * 64 * 32 / 62.5e6
    plain = None
    launches_of, summary = {}, {}
    for feed, (flags, kern) in APP_FEEDS.items():
        app = APAReadoutApp(n_links=N_LINKS, algorithm="AbsRS", threshold=150,
                            threshold_on_collection=True, device=dev,
                            **flags)
        fetched = []
        fetch = app._fetch_hits

        def recording_fetch(packed, fetch=fetch, fetched=fetched):
            out = fetch(packed)
            fetched.append(out)
            return out

        app._fetch_hits = recording_fetch
        tpg.reset_launches()
        t0 = time.perf_counter()
        for frames in batches[:N_WARM]:
            app.process_batch(frames)
        warm_s = time.perf_counter() - t0
        app.batch_timings.clear()     # latency_info: steady batches only
        t0 = time.perf_counter()
        for frames in batches[N_WARM:]:
            app.process_batch(frames)
        app.flush()
        wall = time.perf_counter() - t0
        launches = dict(tpg.process_window.kernel_launches)
        info = app.get_info()
        lat = app.latency_info(frames_per_batch=FRAMES)
        rtf = data_seconds / wall
        print(f"  {feed} feed: warm-up {N_WARM} batch in {warm_s:.4f} s "
              f"(set-up, not in the RTF); steady wall {wall:.4f} s for "
              f"{N_TIMED} batches, data {data_seconds:.6f} s, "
              f"end_to_end_rtf {rtf:.4f}")
        print(f"  {feed} feed info:", json.dumps({k: info[k] for k in (
            "total_hits", "total_tps_sent", "ts_errors", "hits_dropped",
            "tpsets_queued", "raw_buffered")}), "launches",
            json.dumps(launches))
        print(f"  {feed} feed latency_info:", json.dumps(lat))
        want = {k: 0 for k in launches}
        want[kern] = N_WARM + N_TIMED
        if launches != want:
            raise AssertionError(f"{feed} feed: launches {launches}, want "
                                 f"{want}")
        if not (info["total_hits"] > 0 and info["ts_errors"] == 0
                and info["tpsets_queued"] > 0):
            raise AssertionError(f"{feed} feed: slice output wrong: {info}")
        if plain is None:
            # one plain result for every feed: the same frames give the
            # same function
            rmf = np.concatenate([p.register_memory_factor
                                  for p in app.procs])
            plain = list(plain_app_hits(checked_adcs, rmf, app.cfg,
                                        app.k_slots, dev))
        for b, (want_h, d_want) in enumerate(plain):
            hits, d = fetched[b]
            if d != d_want or not np.array_equal(hits, want_h):
                raise AssertionError(
                    f"{feed} feed batch {b}: app hits ({len(hits)}, dropped "
                    f"{d}) differ from the plain version ({len(want_h)}, "
                    f"dropped {d_want})")
            print(f"  {feed} feed batch {b}: {len(hits)} hits, {d} dropped "
                  "== plain")
        split = apa_stage_split(app, batches[-1], feed)
        print(f"  {feed} feed stage split, one batch, ms (medians of 5, each "
              "stage synced):",
              json.dumps({k: round(v, 4) for k, v in split.items()}))
        launches_of[feed] = launches[kern]
        summary[feed] = {"end_to_end_rtf": round(rtf, 4),
                         "proc_ms_p50": lat["proc_ms_p50"],
                         "proc_ms_p95": lat["proc_ms_p95"]}
    print("  apa feeds:", json.dumps(summary))
    return launches_of


def make_wib2_procs(time2: bool, dev):
    procs, sinks = [], []
    for link in range(WIB2_LINKS):
        sink = QueueSender()
        p = WIB2FrameProcessor(tp_sink=sink, device=dev)
        p.conf({"source_id": link, "crate_id": 1, "slot_id": 0,
                "link_id": link, "enable_tpg": True, "tpg_algorithm": "FIR",
                "tpg_threshold": 5, "tp_timeout": 100_000,
                "tpg_time2_feed": time2})
        p.start()
        procs.append(p)
        sinks.append(sink)
    return procs, sinks


def wib2_stage_split(procs, superchunks, time2: bool, n_rep: int = 5):
    """One batch of every link through the processor's steps one at a
    time, each ended by a device sync: median ms per stage, summed over
    the links.  The processors' carried state is left untouched."""
    stages = {}
    for l, p in enumerate(procs):
        C = p.N_CHANNELS
        frames = wib2.superchunk_frames(superchunks[l])
        tc = tpg.auto_tc(WIB2_T, cap=kernel_knobs(p.tpg_cfg)["tc"])
        reps = []
        for _ in range(n_rep):
            r = {}
            words, r["host words"] = clock(lambda: np.ascontiguousarray(
                wib2.adc_region_u32(frames)).reshape(1, -1, wib2.ADC_WORDS))
            if time2:
                host, r["host codec"] = clock(lambda: p._host_time2(words))
                feed, r["H2D"] = clock(lambda: torch.from_numpy(host).to(
                    p.device).reshape(WIB2_T // 2, C))
            else:
                dw, r["H2D"] = clock(lambda: p._device_words(words))
                feed, r["unpack"] = clock(lambda: wib2.unpack_frames(
                    dw.transpose(0, 1)).reshape(WIB2_T, C))
            (slots, nclose, _), r["kernel"] = clock(
                lambda: tpg.process_window(feed, p._dev_state, p.tpg_cfg,
                                           tc, p.k_slots, time2))
            packed, r["compaction"] = clock(lambda: compact_on_device(
                slots, nclose, 0, C, max(2048, 2 * C)))
            (hits, _), r["fetch"] = clock(lambda: unpack_compact(packed))
            _, r["TP tail"] = clock(lambda: p.process_swtpg_hits(
                hits, int(wib2.get_timestamp(frames[0, :1])[0])))
            reps.append(r)
        for k in reps[0]:
            stages[k] = stages.get(k, 0.0) + statistics.median(
                r[k] for r in reps)
    return stages


def wib2_slice(time2: bool, batches, checked, dev):
    """Phase 5, one ingest mode.  Returns the kernel launch counts of the
    processors' run."""
    mode = "time2 feed" if time2 else "packed ingest"
    procs, sinks = make_wib2_procs(time2, dev)
    fetched = [[None] * WIB2_LINKS for _ in range(N_CHECKED)]
    batch_idx = [0]
    for l, p in enumerate(procs):
        def recording(hits, timestamp, p=p, l=l, orig=p.process_swtpg_hits):
            b = batch_idx[0]
            if b < N_CHECKED:
                fetched[b][l] = (hits, p.metrics.count("num_hits_dropped"))
            return orig(hits, timestamp)
        p.process_swtpg_hits = recording
    n_tps = 0
    batch_ms = []
    tpg.reset_launches()
    t_all = time.perf_counter()
    for b, sc in enumerate(batches):
        batch_idx[0] = b
        t0 = time.perf_counter()
        for l, p in enumerate(procs):
            p.process(sc[l])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if b == 0:
            t_steady = time.perf_counter()
        for s in sinks:
            n_tps += sum(len(x) for x in s.drain())
    wall = time.perf_counter() - t_steady
    launches = dict(tpg.process_window.kernel_launches)
    wall_all = time.perf_counter() - t_all
    n_b = len(batches)
    want = {"K1": 0, "K2": 0 if time2 else n_b * WIB2_LINKS,
            "K3": n_b * WIB2_LINKS, "K4": 0}
    data_s = WIB2_TIMED * WIB2_T * WIB2_TICK_S
    steady = batch_ms[1:]
    print(f"  {mode}: warm-up batch {batch_ms[0]:.3f} ms (set-up, not in the "
          f"RTF); steady wall {wall:.4f} s for {WIB2_TIMED} batches, data "
          f"{data_s:.6f} s, end_to_end_rtf {data_s / wall:.4f}; ms/batch "
          f"p50 {statistics.median(steady):.3f} min {min(steady):.3f} max "
          f"{max(steady):.3f} ({wall_all:.3f} s with the warm-up)")
    metrics = {k: sum(p.metrics.count(k) for p in procs) for k in (
        "num_hits", "num_hits_dropped", "num_tps_sent", "num_ts_errors")}
    print(f"  {mode}: {json.dumps(metrics)}, TPs drained {n_tps}, launches "
          f"{json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"{mode}: launches {launches}, want {want}")
    if not (metrics["num_tps_sent"] > 0 and n_tps > 0
            and metrics["num_ts_errors"] == 0):
        raise AssertionError(f"{mode}: slice output wrong: {metrics}")
    prev_drop = [0] * WIB2_LINKS
    for b, want_links in enumerate(plain_processor_hits(checked, procs,
                                                        time2, dev)):
        n_h = n_d = 0
        for l, (want_h, want_d) in enumerate(want_links):
            hits, drop_total = fetched[b][l]
            d = drop_total - prev_drop[l]
            prev_drop[l] = drop_total
            if d != want_d or not np.array_equal(hits, want_h):
                raise AssertionError(
                    f"{mode} batch {b} link {l}: hits ({len(hits)}, dropped "
                    f"{d}) differ from the plain version ({len(want_h)}, "
                    f"dropped {want_d})")
            n_h += len(hits)
            n_d += d
        print(f"  {mode} batch {b}: {n_h} hits, {n_d} dropped over "
              f"{WIB2_LINKS} links == plain")
    split = wib2_stage_split(procs, batches[-1], time2)
    print(f"  {mode} stage split, one batch of {WIB2_LINKS} links, ms "
          "(medians of 5, each stage synced):",
          json.dumps({k: round(v, 4) for k, v in split.items()}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with phase("1 device"):
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        smi = nvidia_smi()
        print(f"device: {name}, capability {cap}, count "
              f"{torch.cuda.device_count()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        print(smi)
        if cap != (9, 0):
            raise RuntimeError(f"the kernels are built for sm_90a; this "
                               f"card is capability {cap}")

    with phase("2 build"):
        lib = _build.build("tpg")
        print(f"built {lib.name}")
        if "tpg" in _build.build_log:
            print("  ptxas:", ptxas_summary(_build.build_log["tpg"]))
        _build.load("tpg")

    with phase("3 kernel vs plain"):
        kernels = kernel_vs_plain(dev)

    with phase("4 apa slice"):
        app_launches = apa_slice(dev)
        kernels["K1"]["launches"] = app_launches["time2"]
        kernels["K4"]["launches"] = (app_launches["fused"]
                                     + app_launches["words14"])

    with phase("5 wib2 slice"):
        t0 = time.perf_counter()
        batches, checked = [], []
        for b in range(1 + WIB2_TIMED):
            sc, adcs = wib2_superchunks(
                WIB2_LINKS, WIB2_SC, seed=SEED + b,
                ts0=0x1000000 + b * WIB2_SC * wib2.SUPERCHUNK_TICK_DIFFERENCE)
            batches.append(sc)
            if b < N_CHECKED:
                checked.append(adcs)
        print(f"  data: {len(batches)} batches of {WIB2_LINKS} x {WIB2_SC} "
              f"superchunks in {time.perf_counter() - t0:.3f} s")
        packed = wib2_slice(False, batches, checked, dev)
        time2 = wib2_slice(True, batches, checked, dev)
        kernels["K2"]["launches"] = packed["K2"] + app_launches["packed"]
        kernels["K3"]["launches"] = packed["K3"] + time2["K3"]

    print(smi)
    print(json.dumps({"kernels": [
        {"name": f"tpg {k} ({kernels[k]['timed']})", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES[k],
         "launches": kernels[k]["launches"],
         "max_abs_err": kernels[k]["max_abs_err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"]}
        for k in ("K1", "K2", "K3", "K4")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
