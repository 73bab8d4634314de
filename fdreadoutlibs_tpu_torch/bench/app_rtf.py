"""Whole-application sustained RTF on the card: ``APAReadoutApp`` end to
end, packed WIBEth bytes -> TPSets, in the production configuration.

Counterpart of ``scripts/bench_app_rtf.py`` (``generate_batches`` :64-89,
``run_mode`` :109-164, ``measure_device_compute`` :167-250, ``projection``
:252-291, ``run_bench`` :294-347) and of bench.py's ``app_rtf`` cell
(:609-627), one function here (``bench_app_rtf``).  The chain: batched
sequence/timestamp preprocess -> zero-copy raw retention -> the feed (the
time2 host codec, as the JAX bench) -> the kernel -> one compact-hit
fetch -> batched whole-APA TP assembly -> the TP latency buffer -> TPSet
windowing, drained by a consumer.  The reference's
unit of deployment is this chain (WIBEthFrameProcessor.cpp:411-572 feeding
TPCTPRequestHandler.cpp:100-193), not any one kernel.

``rtf_pipelined`` and ``rtf_unpipelined`` are data seconds over wall
seconds of ``timed`` batches after ``warm``, on the time2 feed; the fused
(K4) and packed (device unpack + K2) feeds stand beside it under
``feeds``.  ``projection`` is the JAX bench's stage-overlap model: every
host stage on cores of its own, double-buffered transfers, so one card
sustains span / max(device compute, transfer); the device compute is the
app's exact per-batch device work (``process_time2_feed`` +
``compact_on_device``, k_slots 4, state chained, two resident feeds in
turn) timed with CUDA events, the transfer the app's own copies across
the host link (the feed up from pageable memory, the compact hits down)
timed in the same run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native
from ..formats import wibeth
from ..formats.fragment import Fragment
from ..ops import TPGConfig, ingest
from ..ops.tpg import auto_tc
from ..utils.tuning import kernel_knobs
from . import mixed_rmf, seeded_state, time2_words, time_chain

TS0 = 0x1000000
# the production configuration and source of the JAX script's run_bench
# (bench_app_rtf.py:294-297); the host codec on one core
ALGORITHM, THRESHOLD = "AbsRS", 150
SIGNAL_RATE = 0.0025
CODEC_THREADS = 1
# bench.py's cell (:617)
LINKS, FRAMES = 40, 128
SPAN_S_PER_FRAME = wibeth.N_TIME_SAMPLES * 32 / 62.5e6
# the app's constructor flags of each feed
FEEDS = {"time2": {"time2_feed": True}, "fused": {"fused_unpack": True},
         "packed": {}}


def generate_batches(L: int, N: int, B: int, signal_rate_per_frame: float,
                     seed: int = 0):
    """B distinct (L, N, 7200) uint8 WIBEth batches with continuous
    timestamps and sequence ids, made before the timed loop and never
    mutated after (the zero-copy retention contract)."""
    rng = np.random.default_rng(seed)
    ts = TS0
    batches = []
    for b in range(B):
        frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
        adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))) \
            .astype(np.uint16)
        n_sig = int(rng.poisson(signal_rate_per_frame * N * L * 64))
        for _ in range(n_sig):
            link, c = rng.integers(0, L), rng.integers(0, 64)
            f, t = rng.integers(0, N), rng.integers(0, 50)
            adcs[link, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
        for link in range(L):
            wibeth.set_adcs(frames[link], adcs[link])
            wibeth.fake_timestamps(frames[link], ts)
            wibeth.fake_seq_ids(frames[link], b * N)
            wibeth.fake_geoid(frames[link], 1, link // 8, link % 8)
        batches.append(frames)
        ts += N * wibeth.EXPECTED_TICK_DIFFERENCE
    return batches


def _stage_p50s(rows):
    keys = [k for k in rows[0] if k != "total_ms"]
    return {k: round(float(np.percentile([r[k] for r in rows], 50)), 3)
            for k in keys}


def run_mode(batches, L: int, N: int, warm: int, timed: int,
             pipelined: bool, feed: str = "time2", device="cuda") -> dict:
    """One timed pass over the made stream: the sustained RTF, the stages'
    p50s, and that TPSets flowed and a data request was served in the same
    run."""
    from ..apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(
        n_links=L, algorithm=ALGORITHM, threshold=THRESHOLD,
        threshold_on_collection=True, codec_threads=CODEC_THREADS,
        batched_assembly=True, raw_capacity_frames=max(4096, 4 * N),
        raw_retention="zerocopy", pipelined=pipelined, device=device,
        **FEEDS[feed])
    for fb in batches[:warm]:
        app.process_batch(fb)
    app.batch_timings.clear()
    tpsets0 = app.handler.metrics.count("num_tpsets_sent")
    drained = 0

    t0 = time.perf_counter()
    for fb in batches[warm:warm + timed]:
        app.process_batch(fb)
        # the downstream consumer: an undrained queue eventually refuses
        # sends and the handler stops windowing
        drained += len(app.tpset_q.drain())
    app.flush()
    wall = time.perf_counter() - t0

    drained += len(app.tpset_q.drain())
    info = app.get_info()
    data_seconds = timed * N * SPAN_S_PER_FRAME
    out = {
        "rtf": round(data_seconds / wall, 3),
        "wall_s": round(wall, 3),
        "data_s": round(data_seconds, 4),
        "stages_ms_p50": _stage_p50s(list(app.batch_timings)),
        "tpsets_sent_timed": app.handler.metrics.count("num_tpsets_sent")
        - tpsets0,
        "tpsets_drained": drained,
        "total_tps_sent": info["total_tps_sent"],
        "total_hits": info["total_hits"],
        "ts_errors": info["ts_errors"],
        "raw_frames_buffered": info["raw_buffered"],
    }
    # the data-request path on the same run: a raw fragment of a recent
    # window on link 0, round-tripped through its binary form
    last_ts = TS0 + (warm + timed) * N * wibeth.EXPECTED_TICK_DIFFERENCE
    start = last_ts - 64 * wibeth.EXPECTED_TICK_DIFFERENCE
    frag = app.readout[0].request_fragment(
        start, last_ts, run_number=app.run_number, trigger_number=1,
        source_id=0)
    blob = frag.to_bytes()
    if Fragment.from_bytes(blob).header.window_begin != \
            frag.header.window_begin:
        raise AssertionError("the fragment's window does not round-trip")
    out["fragment_payloads"] = len(frag)
    out["fragment_bytes"] = len(blob)
    return out


def device_inputs(L: int, N: int, cfg: TPGConfig, device):
    """The inputs of the app's device work at L links x N frames
    (bench_app_rtf.py:187-205): the seeded state of a window of noise and
    100 pulses (seed 3) with threshold-on-collection memory factors, and
    the unpadded time2 feeds (``relayout_time2(pad8=False)``'s rows) of the
    window and of its half-window roll."""
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    rng = np.random.default_rng(3)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(100):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    feeds = []
    for a in (adcs, np.roll(adcs, T // 2, axis=0)):
        feeds.append(time2_words(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)))
    return seeded_state(adcs, mixed_rmf(cfg, C), device), feeds


def measure_device_compute(L: int, N: int, trials: int = 3,
                           device="cuda") -> float:
    """Milliseconds of device time per batch of the app's exact device
    work (``process_time2_feed`` + ``compact_on_device`` at the app's
    shapes, tc and k_slots 4, state chained) on :func:`device_inputs`' two
    feeds in turn: the median of ``trials`` chains of 7 batches (the JAX
    script's longer chain)."""
    device = torch.device(device)
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    cfg = TPGConfig.from_raw(ALGORITHM, threshold=THRESHOLD)
    knobs = kernel_knobs(cfg)
    state, feeds = device_inputs(L, N, cfg, device)
    tc = auto_tc(T, cap=knobs["tc"])
    max_hits = max(2048, 2 * C)

    def step(s, i):
        # k_slots 4: the app's capacity (APAReadoutApp.k_slots)
        slots, nclose, s = ingest.process_time2_feed(
            feeds[i % 2], s, cfg, C, tc=tc, k_slots=4,
            fir_twopass=knobs["fir_twopass"], geometry=knobs["geometry"])
        ingest.compact_on_device(slots, nclose, 0, C, max_hits)
        return s

    per = time_chain(step, state, 7, trials, device)
    return float(np.median(per)) * 1e3


def measure_transfer_ms(L: int, N: int, trials: int = 3,
                        device="cuda") -> float:
    """Milliseconds per batch of the app's own copies across the host
    link: the unpadded time2 feed up from pageable host memory, as
    ``APAReadoutApp._device_submit`` ships it, and the compact hits down
    (``compact_on_device``'s rows and trailer): the host clock ending with
    ``torch.cuda.synchronize``, the median of ``trials`` runs of 7 batches
    after a warm-up batch."""
    device = torch.device(device)
    C = L * wibeth.N_CHANNELS
    feed = np.zeros(native.time2_feed_shape(L, N * wibeth.N_TIME_SAMPLES,
                                            pad8=False), np.int32)
    hits = torch.zeros((max(2048, 2 * C) + 1, 6), dtype=torch.int32,
                       device=device)

    def batches(n):
        t0 = time.perf_counter()
        for _ in range(n):
            torch.from_numpy(feed).to(device, copy=True)
            hits.to("cpu", copy=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3 / n

    batches(1)
    return float(np.median([batches(7) for _ in range(trials)]))


def projection(span_ms: float, unpiped: dict, device_compute_ms: float,
               transfer_mb: float, link_GBps: float) -> dict:
    """The stage-overlap model: every host stage owns its cores, the
    depth-2 pipeline overlaps the device, and double-buffered transfers
    overlap compute, so one card sustains span / max(compute, transfer),
    provided the host feeds it.  ``link_GBps`` is the host link's rate for
    the app's copies (:func:`measure_transfer_ms`: ``transfer_mb`` over its
    milliseconds).  The host's need is published as unit costs: cores per
    real-time APA for the codec and for the preprocess, retention, assembly
    and handler tail, on this host's cores."""
    st = unpiped["stages_ms_p50"]
    host_tail_ms = sum(st[k] for k in ("preprocess_ms", "retention_ms",
                                       "assembly_ms", "handler_ms"))
    transfer_ms = transfer_mb / link_GBps      # MB / (GB/s) = ms
    device_ms = max(device_compute_ms, transfer_ms)
    chip_rtf = span_ms / device_ms
    codec_cores_per_apa = st["codec_ms"] / span_ms
    tail_cores_per_apa = host_tail_ms / span_ms
    cores_per_apa = codec_cores_per_apa + tail_cores_per_apa
    return {
        "assumes": {"link_GBps": round(link_GBps, 3),
                    "overlap": "depth-2 pipeline; double-buffered DMA",
                    "device_compute": "CUDA events on the card, resident "
                                      "feeds",
                    "transfer": "the app's pageable feed copy up and hit "
                                "copy down, host clock to synchronize, "
                                "this run"},
        "stage_ms": {"device_compute_ms": round(device_compute_ms, 3),
                     "transfer_ms": round(transfer_ms, 3),
                     "codec_ms_1core": round(st["codec_ms"], 3),
                     "host_tail_ms_1core": round(host_tail_ms, 3)},
        "device_bottleneck": ("transfer" if transfer_ms > device_compute_ms
                              else "compute"),
        "host_cores_per_realtime_apa": {
            "codec": round(codec_cores_per_apa, 2),
            "tail": round(tail_cores_per_apa, 2)},
        "chip_bound_rtf": round(chip_rtf, 2),
        "host_cores_to_sustain_chip_rtf": round(chip_rtf * cores_per_apa,
                                                1),
        "projected_rtf": round(chip_rtf, 2),
    }


def bench_app_rtf(device="cuda", warm: int = 2, timed: int = 8,
                  trials: int = 3) -> dict:
    """bench.py's ``app_rtf`` cell (:609-627, ``run_bench(links=40,
    frames=128, warm=2, timed=8)``): the time2 feed sync and pipelined, the
    projection, and the fused and packed feeds beside it under ``feeds``;
    raises unless every run sent TPs with no timestamp error."""
    L, N = LINKS, FRAMES
    t_gen = time.perf_counter()
    batches = generate_batches(L, N, warm + timed, SIGNAL_RATE)
    gen_s = time.perf_counter() - t_gen

    span_ms = N * SPAN_S_PER_FRAME * 1e3
    common = dict(L=L, N=N, warm=warm, timed=timed, device=device)
    runs = {feed: {"unpipelined": run_mode(batches, pipelined=False,
                                           feed=feed, **common),
                   "pipelined": run_mode(batches, pipelined=True, feed=feed,
                                         **common)}
            for feed in FEEDS}
    unpiped, piped = runs["time2"]["unpipelined"], runs["time2"]["pipelined"]
    bad = [r for rs in runs.values() for r in rs.values()
           if r["ts_errors"] or r["total_hits"] <= 0]
    if bad or piped["total_tps_sent"] <= 0:
        raise AssertionError(
            "app runs: hits " + str({f: [r["total_hits"] for r in rs.values()]
                                     for f, rs in runs.items()})
            + f", TPs sent {piped['total_tps_sent']}, timestamp errors "
            + str({f: [r["ts_errors"] for r in rs.values()]
                   for f, rs in runs.items()}))

    # per-batch device traffic: the unpadded time2 feed up, the compact
    # hits down
    C = L * 64
    feed_mb = int(np.prod(native.time2_feed_shape(
        L, N * wibeth.N_TIME_SAMPLES, pad8=False))) * 4 / 1e6
    hits_mb = (max(2048, 2 * C) + 1) * 6 * 4 / 1e6
    transfer_mb = feed_mb + hits_mb
    dev_ms = measure_device_compute(L, N, trials, device)
    transfer_ms = measure_transfer_ms(L, N, trials, device)
    return {
        "rtf_pipelined": piped["rtf"],
        "rtf_unpipelined": unpiped["rtf"],
        "batch_span_ms": round(span_ms, 3),
        "device_transfer_mb_per_batch": round(transfer_mb, 2),
        "projection": projection(span_ms, unpiped, dev_ms, transfer_mb,
                                 transfer_mb / transfer_ms),
        "config": {"links": L, "frames_per_batch": N,
                   "batches_timed": timed, "algorithm": ALGORITHM,
                   "threshold_on_collection": True,
                   "feed": "time2", "retention": "zerocopy",
                   "assembly": "batched", "source_pregen_s": round(gen_s, 1)},
        "feeds": {feed: {"rtf_pipelined": r["pipelined"]["rtf"],
                         "rtf_unpipelined": r["unpipelined"]["rtf"],
                         "stages_ms_p50_unpipelined":
                             r["unpipelined"]["stages_ms_p50"],
                         "total_hits": r["unpipelined"]["total_hits"],
                         "ts_errors": r["unpipelined"]["ts_errors"]}
                  for feed, r in runs.items() if feed != "time2"},
        "tpsets_emitted": piped["tpsets_drained"],
        "tps_sent": piped["total_tps_sent"],
        "ts_errors": piped["ts_errors"],
    }
