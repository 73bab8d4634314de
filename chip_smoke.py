#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. device  — requires a CUDA card of capability (9, 0); prints its name and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build   — compiles ``fdreadoutlibs_tpu_torch/csrc/tpg_time2.cu`` with nvcc;
3. kernel  — the hand-written kernel against its plain PyTorch version on
   the card at the APA batch shape (T=8192 x 2560 channels, tc=256, K=4)
   for SimpleThreshold, AbsRS and StandardRS: slots, nclose and state must
   be bit-equal; both are timed there;
4. slice   — the production APA app (40 WIBEth links, AbsRS,
   threshold-on-collection, time2 feed) on the card: one warm-up batch of
   128 frames per link (timed apart, as set-up), then a steady window of
   32 batches for the end-to-end RTF and ``latency_info``; the kernel must
   have launched once per batch, and the first 2 batches' hits must equal
   the kernel's plain version plus the same compaction run on the same
   ADCs with the carried state.

The last lines are the card's name and power limit, one JSON object per
kernel, and the result line ``{"ok": true, "device": {...}}``.  Imports
only ``torch``, numpy and the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, _build,
                                         init_chanstate, seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.ops.ingest import compact_on_device, unpack_compact
from fdreadoutlibs_tpu_torch.testing import time2_words, tpg_stream
from fdreadoutlibs_tpu_torch.utils.tuning import kernel_knobs

N_LINKS = 40                 # one APA
C_APA = N_LINKS * 64         # 2560 channels
T_APA = 8192                 # ticks per APA batch (128 frames)
TC, K = 256, 4
FRAMES = 128
N_WARM, N_TIMED, N_CHECKED = 1, 32, 2
SEED = 20260


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
    """Mean ms per call over n calls, each after an L2 flush (the app's
    kernel reads a feed that was just copied in, not a warm cache)."""
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


def plain_app_hits(adcs_batches, rmf, cfg, k_slots: int, dev):
    """What the app must fetch for consecutive batches of (T, C) ADCs: the
    kernel's plain version, with the app's state seeding, chunking and
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
        lib = _build.build("tpg_time2")
        print(f"built {lib.name}")
        for line in _build.build_log.get("tpg_time2", "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        _build.load("tpg_time2")

    cfgs = {"SimpleThreshold": TPGConfig(threshold=150),
            "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
            "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                    threshold=150)}
    times = {}
    max_err = 0
    with phase("3 kernel vs plain"):
        adcs, rmf = tpg_stream(T_APA, C_APA, TC, K, SEED)
        seeded = seed_chanstate(init_chanstate(C_APA), adcs[0], rmf)
        state = tpg.pack_state(seeded, C_APA, device=dev)
        feed = torch.from_numpy(time2_words(adcs)).to(dev)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        for fam, cfg in cfgs.items():
            got = tpg.launch_time2_kernel(feed, state, cfg, TC, K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = tpg.process_window_plain(feed, state, cfg, TC, K)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for g, w, what in zip(got, want, ("slots", "nclose", "state")):
                err = int((g.long() - w.long()).abs().max())
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(f"{fam}: kernel {what} differs from "
                                         f"the plain version (max |d| {err})")
            n_hits = int((got[0][:, :, 2] != 0).sum())
            n_over = int(got[1].max())
            if n_hits == 0 or n_over <= K:
                raise AssertionError(f"{fam}: weak check ({n_hits} hits, "
                                     f"max closes per chunk {n_over})")
            ms = time_kernel(lambda: tpg.launch_time2_kernel(
                feed, state, cfg, TC, K), 20, flush)
            times[fam] = (ms, plain_ms)
            print(f"  {fam}: T={T_APA} x {C_APA} ch bit-equal ({n_hits} "
                  f"hits, max {n_over} closes/chunk); kernel {ms:.4f} "
                  f"ms/batch, plain {plain_ms:.1f} ms/batch")
        del flush

    with phase("4 slice"):
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
        app = APAReadoutApp(n_links=N_LINKS, algorithm="AbsRS", threshold=150,
                            threshold_on_collection=True, time2_feed=True,
                            device="cuda")
        fetched = []
        fetch = app._fetch_hits

        def recording_fetch(packed):
            out = fetch(packed)
            fetched.append(out)
            return out

        app._fetch_hits = recording_fetch
        tpg.process_window.launches = 0
        t0 = time.perf_counter()
        for frames in batches[:N_WARM]:
            app.process_batch(frames)
        warm_s = time.perf_counter() - t0
        app.batch_timings.clear()         # latency_info: steady batches only
        t0 = time.perf_counter()
        for frames in batches[N_WARM:]:
            app.process_batch(frames)
        app.flush()
        wall = time.perf_counter() - t0
        launches = tpg.process_window.launches
        info = app.get_info()
        data_seconds = N_TIMED * FRAMES * 64 * 32 / 62.5e6
        print(f"  warm-up: {N_WARM} batch in {warm_s:.4f} s (set-up, not "
              f"in the RTF)")
        print(f"  steady: wall {wall:.4f} s for {N_TIMED} batches, data "
              f"{data_seconds:.6f} s, end_to_end_rtf "
              f"{data_seconds / wall:.4f}")
        print("  info:", json.dumps({k: info[k] for k in (
            "total_hits", "total_tps_sent", "ts_errors", "hits_dropped",
            "tpsets_queued", "raw_buffered")}))
        print("  latency_info:", json.dumps(
            app.latency_info(frames_per_batch=FRAMES)))
        if launches != N_WARM + N_TIMED:
            raise AssertionError(f"kernel launched {launches} times for "
                                 f"{N_WARM + N_TIMED} batches")
        if not (info["total_hits"] > 0 and info["ts_errors"] == 0
                and info["tpsets_queued"] > 0):
            raise AssertionError(f"slice output wrong: {info}")
        rmf = np.concatenate([p.register_memory_factor for p in app.procs])
        for b, (want, d_want) in enumerate(plain_app_hits(
                checked_adcs, rmf, app.cfg, app.k_slots, dev)):
            hits, d = fetched[b]
            if d != d_want or not np.array_equal(hits, want):
                raise AssertionError(
                    f"batch {b}: app hits ({len(hits)}, dropped {d}) differ "
                    f"from the plain version ({len(want)}, dropped {d_want})")
            print(f"  batch {b}: {len(hits)} hits, {d} dropped == plain")

    ms, plain_ms = times["AbsRS"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "tpg_time2", "route": "cuda",
        "source": "fdreadoutlibs_tpu_torch/csrc/tpg_time2.cu",
        "replaces": "fdreadoutlibs_tpu/ops/pallas_tpg.py:439",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
