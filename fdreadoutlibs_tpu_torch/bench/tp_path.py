"""Host TP-path (L3/L4) throughput: can the host layers that consume the
kernel's hits keep up with an APA's trigger-primitive rate?  CPU only.

Counterpart of ``scripts/bench_tp_path.py`` and of
``bench.py::bench_host_tp_path`` (:389-423), on the port's modules.  Stages,
mirroring the reference's post-kernel call stack
(WIBEthFrameProcessor.cpp:479-572 -> TPCTPRequestHandler.cpp:100-193):

1. ``tp_assembly`` — hit records -> TriggerPrimitives -> channel mask /
   too-long filter -> sink (``WIBEthFrameProcessor.process_swtpg_hits``),
   per link in small and large batches, and batched over a whole APA
   (``stream.wibeth.assemble_tps``, as ``APAReadoutApp`` does);
2. ``latency_buffer`` — ordered TP insertion and windowed extraction
   (``tp/latency_buffer.py``: the Python buffer and the native one);
3. ``request_handler`` — ``TPRequestHandler``'s insert, stream time,
   TPSet windowing and cutoff loop, then data requests on the loaded buffer;
4. ``wib_tp_handler`` — the legacy ``WIBTPHandler`` heap path;
5. ``apa_host_loop`` — ``APAReadoutApp.process_batch`` with the device pass
   replaced by canned hits, beside a same-session 32 MB memcpy yardstick.

Requirement anchor: 2560 channels x 100 Hz = 256k TPs/s per APA, 40 links
x 1 batch/ms.  Rates are medians over ``trials`` runs on pre-generated
data.
"""

from __future__ import annotations

import time

import numpy as np

from ..formats import wibeth
from ..formats.trigprim import TP_DTYPE
from ..ops.hits import HIT_DTYPE
from ..stream.transport import QueueSender
from ..stream.wibeth import WIBEthFrameProcessor, assemble_tps
from ..tp.latency_buffer import (LatencyBuffer, NativeLatencyBufferAdapter,
                                 make_latency_buffer)
from ..tp.request_handler import TPRequestHandler
from ..tp.wib_tp_handler import WIBTPHandler
from ..utils.metrics import MetricsCollector

APA_CHANNELS = 2560
APA_LINKS = 40
REQ_TPS_PER_S = 256_000          # 100 Hz/ch ceiling assumption
REQ_CALLS_PER_S = APA_LINKS * 1000   # 40 links x ~1 ms batches


def _median_rate(fn, n_items: int, trials: int) -> float:
    """Median items/s of fn() over ``trials`` runs."""
    dts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        dts.append(time.perf_counter() - t0)
    return n_items / float(np.median(dts))


def make_hits(n: int, rng, ticks: int = 2048,
              channels: int = wibeth.N_CHANNELS) -> np.ndarray:
    h = np.zeros(n, dtype=HIT_DTYPE)
    h["channel"] = rng.integers(0, channels, n)
    h["end_tick"] = np.sort(rng.integers(1, ticks, n)).astype(np.int32)
    h["tover"] = rng.integers(1, 60, n)
    h["charge"] = rng.integers(1, 30_000, n)      # nonzero u16 -> kept
    h["peak_adc"] = rng.integers(1, 16_000, n)
    h["peak_time"] = rng.integers(0, 60, n)
    return h


def make_tps(n: int, rng, t0: int = 0, span: int = 1 << 20) -> np.ndarray:
    tps = np.zeros(n, dtype=TP_DTYPE)
    tps["time_start"] = t0 + np.sort(rng.integers(0, span, n)).astype(
        np.uint64)
    tps["time_peak"] = tps["time_start"] + 32
    tps["time_over_threshold"] = rng.integers(32, 2048, n)
    tps["channel"] = rng.integers(0, APA_CHANNELS, n)
    tps["adc_integral"] = rng.integers(1, 60_000, n)
    tps["adc_peak"] = rng.integers(1, 16_000, n)
    return tps


def bench_tp_assembly(trials: int, rng) -> dict:
    """Stage 1: per-link hit->TP assembly, and batched over the APA."""
    sink = QueueSender(capacity=1 << 30)
    proc = WIBEthFrameProcessor(tp_sink=sink, device="cpu")
    proc.conf({"enable_tpg": True, "tpg_backend": "scan",
               "tpg_algorithm": "AbsRS", "tpg_threshold": 120,
               "channel_map_name": "HDAPAChannelMap",
               "tpg_channel_mask": [7, 19]})   # exercise the mask path
    proc.start()
    frames = wibeth.empty_frames(1)
    wibeth.fake_geoid(frames, 0, 0, 0)
    # the seeding call alone: find_hits would run the TPG too, and this
    # stage isolates the post-kernel assembly cost
    proc._first_frame_setup(frames, np.zeros(wibeth.N_CHANNELS, np.int32))

    out = {}
    for label, batch, reps in (("small_batch8", 8, 2000),
                               ("large_batch4096", 4096, 50)):
        batches = [make_hits(batch, rng) for _ in range(reps)]

        def run(batches=batches):
            ts = 0
            for h in batches:
                proc.process_swtpg_hits(h, ts)
                ts += 2048 * 32
            sink.drain()

        rate = _median_rate(run, len(batches) * batch, trials)
        out[label] = {"hits_per_s": round(rate),
                      "calls_per_s": round(rate / batch)}
    out["apa_headroom_vs_256k"] = round(
        out["large_batch4096"]["hits_per_s"] / REQ_TPS_PER_S, 1)
    # small batches bound the per-call overhead budget: 40 links x 1 kHz
    out["apa_call_budget_used_pct"] = round(
        100 * REQ_CALLS_PER_S / out["small_batch8"]["calls_per_s"], 1)

    # batched whole-APA assembly (APAReadoutApp._assemble_batch): one
    # assemble_tps call per APA batch instead of 40 per-link calls, with
    # the same mask, too-long filter, channel histogram and link counters
    offline_table = np.tile(proc.register_channels, APA_LINKS) + \
        64 * np.repeat(np.arange(APA_LINKS), wibeth.N_CHANNELS)
    det_table = np.zeros(APA_LINKS, dtype=np.int64)
    apa_reps = 500
    apa_hits = [make_hits(8 * APA_LINKS, rng, channels=APA_CHANNELS)
                for _ in range(apa_reps)]
    ts0 = np.arange(APA_LINKS, dtype=np.int64) * 3    # distinct per link
    mask_keys = np.sort(np.array(
        [(l << 32) | c for l in range(APA_LINKS) for c in (7, 19)],
        dtype=np.int64))
    apa_metrics = MetricsCollector()
    sent_link = np.zeros(APA_LINKS, dtype=np.int64)

    def run_batched():
        for h in apa_hits:
            link = h["channel"] >> 6
            tps, kept = assemble_tps(h, ts0[link], offline_table,
                                     det_table[link], 1)
            kept_link = link[kept]
            keys = (kept_link.astype(np.int64) << 32) \
                | (tps["channel"].astype(np.int64) & 0xFFFFFFFF)
            keep = ~np.isin(keys, mask_keys)
            tps, kept_link = tps[keep], kept_link[keep]
            too_long = tps["time_over_threshold"] > np.uint64(100_000)
            if too_long.any():
                tps, kept_link = tps[~too_long], kept_link[~too_long]
            apa_metrics.add_channel_tps(tps["channel"])
            sent_link[:] += np.bincount(kept_link, minlength=APA_LINKS)

    rate = _median_rate(run_batched, apa_reps * 8 * APA_LINKS, trials)
    out["apa_batched"] = {
        "hits_per_s": round(rate),
        "apa_batches_per_s": round(rate / (8 * APA_LINKS)),
        "vs_40_per_link_calls": round(
            rate / out["small_batch8"]["hits_per_s"], 1),
        # cadence budget: 1 batched call per link-batch interval (~1 kHz)
        "apa_call_budget_used_pct": round(
            100 * 1000 / (rate / (8 * APA_LINKS)), 1)}
    return out


def bench_latency_buffer(trials: int, rng, n_batches: int = 64,
                         batch: int = 4096) -> dict:
    """Stage 2: ordered insertion + windowed extraction, Python and
    native."""
    batches = [make_tps(batch, rng, t0=i * (1 << 20))
               for i in range(n_batches)]
    total = n_batches * batch
    impls = {"python": lambda: LatencyBuffer(dtype=TP_DTYPE)}
    if isinstance(make_latency_buffer(TP_DTYPE), NativeLatencyBufferAdapter):
        impls["native"] = lambda: NativeLatencyBufferAdapter(TP_DTYPE)

    out = {}
    for name, mk in impls.items():
        holder = {}

        def insert_all(mk=mk, holder=holder):
            buf = mk()
            for b in batches:
                buf.insert(b)
            # consolidation is part of the honest insert cost
            buf.occupancy(), buf.newest_ts()
            holder["buf"] = buf

        ins_rate = _median_rate(insert_all, total, trials)
        buf = holder["buf"]
        spans = [(int(i * (1 << 20)), int((i + 2) * (1 << 20)))
                 for i in rng.integers(0, max(1, n_batches - 2), 200)]

        def extract_all(buf=buf, spans=spans):
            for lo, hi in spans:
                buf.extract_window(lo, hi)

        ext_rate = _median_rate(extract_all, len(spans), trials)
        out[name] = {"insert_tps_per_s": round(ins_rate),
                     "extract_windows_per_s": round(ext_rate),
                     "headroom_vs_256k": round(ins_rate / REQ_TPS_PER_S, 1)}
    return out


def bench_request_handler(trials: int, rng, n_batches: int = 256,
                          batch: int = 1024) -> dict:
    """Stage 3: insert -> note_stream_time -> TPSet windowing loop, then
    windowed data requests on the loaded buffer, on both buffers (the APA
    app takes the native one when it is built)."""
    span = 1 << 16
    batches = [make_tps(batch, rng, t0=i * span, span=span)
               for i in range(n_batches)]
    total = n_batches * batch
    impls = {"python": lambda: LatencyBuffer(dtype=TP_DTYPE)}
    if isinstance(make_latency_buffer(TP_DTYPE), NativeLatencyBufferAdapter):
        impls["native"] = lambda: NativeLatencyBufferAdapter(TP_DTYPE)

    out = {}
    for name, mk in impls.items():
        sink = QueueSender(capacity=1 << 30)
        holder = {}

        def run_loop(mk=mk, sink=sink, holder=holder):
            h = TPRequestHandler(tpset_sink=sink, latency_buffer=mk())
            h.conf({"tpset_transmission_rate_hz": 2000,
                    "tpset_min_latency_ticks": 4 * span})
            h.start(run_number=1)
            n_sets = 0
            for i, b in enumerate(batches):
                h.insert_tps(b)
                h.note_stream_time((i + 1) * span)
                if h.send_tp_sets_once() is not None:
                    n_sets += 1
            sink.drain()
            holder["h"], holder["sets"] = h, n_sets

        loop_rate = _median_rate(run_loop, total, trials)
        h = holder["h"]
        reqs = [(int(i * span), int((i + 8) * span))
                for i in rng.integers(0, max(1, n_batches - 8), 200)]

        def serve(h=h, reqs=reqs):
            for lo, hi in reqs:
                h.request_fragment(lo, hi)

        req_rate = _median_rate(serve, len(reqs), trials)
        h.stop()
        out[name] = {"insert_window_tps_per_s": round(loop_rate),
                     "tpsets_emitted": holder["sets"],
                     "data_requests_per_s": round(req_rate),
                     "headroom_vs_256k": round(loop_rate / REQ_TPS_PER_S, 1)}
    return out


def bench_wib_tp_handler(trials: int, rng, n_batches: int = 128,
                         batch: int = 512) -> dict:
    """Stage 4: the legacy WIBTPHandler heap path."""
    span = 1 << 16
    batches = [make_tps(batch, rng, t0=i * span, span=span)
               for i in range(n_batches)]
    total = n_batches * batch
    sink = QueueSender(capacity=1 << 30)

    def run():
        h = WIBTPHandler(tpset_sink=sink)
        h.set_run_number(1)
        for i, b in enumerate(batches):
            h.add_tps(b, current_time=(i + 1) * span)
            h.try_sending_tpsets(current_time=(i + 1) * span)
        sink.drain()

    rate = _median_rate(run, total, trials)
    return {"tps_per_s": round(rate),
            "headroom_vs_256k": round(rate / REQ_TPS_PER_S, 1)}


def memcpy_baseline_GBps() -> float:
    """Same-session core-speed yardstick: the best of 5 32 MB streaming
    copies (beyond the last-level cache).  A shared host core drifts
    between sessions; a share of a core is comparable across sessions only
    divided by this."""
    src = np.ones(32 * 1024 * 1024, np.uint8)
    dst = np.empty_like(src)
    best = 0.0
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        if dt > 0:
            best = max(best, src.nbytes / dt / 1e9)
    return best


def bench_apa_host_loop(trials: int, rng, n_batches: int = 12,
                        links: int = APA_LINKS, frames: int = 16) -> dict:
    """Stage 5: the whole per-APA host loop (``APAReadoutApp.process_batch``)
    with the device pass replaced by canned hits in canonical order:
    sequence/timestamp checks, raw retention and cleanup, batched TP
    assembly, handler windowing and cleanup.  A batch holds the 256k TPs/s
    requirement at its cadence (frames x 32.768 us): 134 hits at 16
    frames, the JAX script's figure."""
    from ..apps.apa_readout import APAReadoutApp

    data_seconds = frames * 64 * 32 / 62.5e6
    hits_per_batch = round(REQ_TPS_PER_S * data_seconds)
    app = APAReadoutApp(n_links=links, algorithm="AbsRS", threshold=120,
                        device="cpu")
    batches = []
    ts = 0x10000
    for b in range(n_batches):
        fr = np.zeros((links, frames, wibeth.FRAME_SIZE), np.uint8)
        for l in range(links):
            wibeth.fake_timestamps(fr[l], ts)
            wibeth.fake_seq_ids(fr[l], b * frames)
            wibeth.fake_geoid(fr[l], 1, l // 8, l % 8)
        batches.append(fr)
        ts += frames * 2048
    hit_batches = [make_hits(hits_per_batch, rng,
                             ticks=frames * 64, channels=links * 64)
                   for _ in range(n_batches)]
    # the app's device seams: _device_submit enqueues and returns a handle,
    # _fetch_hits turns it into (hits, dropped)
    it = {"i": 0}

    def fake_device_submit(frames_links, row, events=None):
        h = hit_batches[it["i"] % n_batches]
        it["i"] += 1
        return h, 0

    app._device_submit = fake_device_submit
    app._fetch_hits = lambda packed: packed

    def run():
        for fr in batches:
            app.process_batch(fr)

    rate = _median_rate(run, n_batches, trials)   # batches/s
    sec_per_batch = 1.0 / rate
    base = memcpy_baseline_GBps()
    pct = 100 * sec_per_batch / data_seconds
    return {"batches_per_s": round(rate, 1),
            "ms_per_batch": round(1e3 * sec_per_batch, 3),
            "data_ms_per_batch": round(1e3 * data_seconds, 3),
            "pct_core_per_apa": round(pct, 1),
            # the yardstick and the reading at a 6.7 GB/s-memcpy core (the
            # JAX package's figures were taken at that core)
            "memcpy_baseline_GBps": round(base, 2),
            "pct_core_per_apa_at_6p7GBps_core": round(pct * base / 6.7, 1),
            "hits_per_batch": hits_per_batch,
            "links": links, "frames_per_batch": frames}


def bench_host_tp_path(trials: int = 3) -> dict:
    """The compact summary ``bench.py`` carries (:389-423): the batched APA
    assembly's share of its cadence budget, the host loop's share of a core
    per APA (raw and at a 6.7 GB/s-memcpy core), the request handler's
    windowing rate on the app's buffer, and the legacy handler's rate;
    beside them the app's latency buffer's insert and extraction rates
    (stage 2, which ``bench.py``'s summary leaves out)."""
    rng = np.random.default_rng(7)
    asm = bench_tp_assembly(trials, rng)
    rh = bench_request_handler(trials, rng)
    wh = bench_wib_tp_handler(trials, rng)
    loop = bench_apa_host_loop(trials, rng)
    # last: the stages before it draw bench.py's data from ``rng``
    lb = bench_latency_buffer(trials, rng)
    prod = rh.get("native") or rh["python"]
    buf = lb.get("native") or lb["python"]
    return {
        "apa_assembly_pct_core": asm["apa_batched"][
            "apa_call_budget_used_pct"],
        "apa_host_loop_pct_core_sharedbox_raw": loop["pct_core_per_apa"],
        "apa_host_loop_pct_core_normalized":
            loop["pct_core_per_apa_at_6p7GBps_core"],
        "apa_host_loop_memcpy_baseline_GBps": loop["memcpy_baseline_GBps"],
        "request_handler_tps_per_s": prod["insert_window_tps_per_s"],
        "request_handler_headroom_vs_256k": prod["headroom_vs_256k"],
        "request_handler_buffer": "native" if "native" in rh else "python",
        "wib_handler_tps_per_s": wh["tps_per_s"],
        "latency_buffer_insert_tps_per_s": buf["insert_tps_per_s"],
        "latency_buffer_extract_windows_per_s": buf[
            "extract_windows_per_s"],
    }
