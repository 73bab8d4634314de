"""Full-APA readout application on PyTorch/CUDA.

Port of ``fdreadoutlibs_tpu/apps/apa_readout.py`` with its four feeds.
Every host stage is the JAX package's code (imported where jax-free,
copied otherwise); only the device seam differs:

  emulated WIBEth sources (40 links)
    -> per-link preprocess (sequence/timestamp checks, vectorized)
    -> raw payloads into per-link readout buffers (zero-copy retention)
    -> the feed, by flag:
       time2_feed: host codec native.relayout_time2_frames(pad8=False),
         14-bit unpack + time pairing read from the frames in place,
         (T/2, ceil(C/128), 128) int32 -> K1;
       fused_unpack: the (L, T, 28) packed frame words as they are -> K4
         (the kernel unpacks in-register);
       words14_feed: host relayout native.relayout_words14 to
         (T, WR, 7, 128) int32 -> K4;
       default: the packed frame words, unpacked on the device -> K2
    -> ONE H2D copy, the hand-written CUDA TPG kernel over all links'
       channels (ops/ingest), on-device compaction
    -> ONE device->host fetch of the compact hit list
    -> ONE vectorized TP assembly over the whole APA batch
    -> TP latency buffer (native C++ when available)
    -> TPSet windowing with heartbeats/cutoff, occupancy-bounded cleanup

``device="cuda"`` (the default) runs the kernel and raises when there is no
card; ``device="cpu"`` runs the kernel's plain version (the CPU tests).
Nothing falls back from one to the other.

Each batch's ``batch_timings`` row is built from its stages' spans
(``utils.logging.span``: host milliseconds, and ``apa.*`` ranges while a
torch profiler records): ``apa.preprocess``, ``apa.retention``,
``apa.words`` (the frames' words copy, and its page's release at the
submit's end; on the time2 feed, which reads the frames in place, only
the view of tick 0 that seeds the first batch), ``apa.codec`` (the
feed's host stage), ``apa.h2d`` (the
pageable copy; the host waits in it), ``apa.tpg`` (the kernel's knobs
and launch), ``apa.compact`` (the compaction's launches), ``apa.fetch``
(the one sync and the decode), ``apa.assembly`` and ``apa.handler``.  On a card two CUDA-event pairs a
batch time the TPG launch and the compaction on the device.

Run:  python -m fdreadoutlibs_tpu_torch.apps.apa_readout --time2-feed \\
          --algorithm AbsRS --threshold-on-collection --frames-per-batch 128
      (or --fused-unpack, --words14-feed, or neither for the packed feed)
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque

import numpy as np
import torch

from .. import native
from ..formats import wibeth
from ..formats.adapters import get_adapter
from ..formats.trigprim import TP_DTYPE
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.ingest import (compact_on_device, process_packed_frames,
                          process_packed_frames_fused, process_time2_feed,
                          process_words14_feed, unpack_compact)
from ..ops.tpg import auto_tc, pack_state
from ..stream.transport import QueueSender
from ..stream.wibeth import WIBEthFrameProcessor, assemble_tps
from ..tp.latency_buffer import make_latency_buffer
from ..tp.readout_buffer import ReadoutRequestHandler
from ..tp.request_handler import TPRequestHandler
from ..utils.logging import span
from ..utils.metrics import MetricsCollector
from ..utils.tuning import kernel_knobs

N_LINKS_PER_APA = 40


def resolve_device(device) -> torch.device:
    """The app's compute device; a CUDA request with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no CUDA "
                           "device; pass device='cpu' to run the plain "
                           "version on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class APAReadoutApp:
    """40-link APA readout with a single fused device hot path."""

    def __init__(self, n_links: int = N_LINKS_PER_APA,
                 algorithm: str = "SimpleThreshold", threshold: int = 150,
                 run_number: int = 1,
                 channel_map_name: str = "HDAPAChannelMap",
                 threshold_on_collection: bool = False,
                 fused_unpack: bool = False,
                 words14_feed: bool = False,
                 time2_feed: bool = False,
                 codec_threads: int = 1,
                 batched_assembly: bool = True,
                 raw_capacity_frames: int = 4096,
                 raw_retention: str = "zerocopy",
                 pipelined: bool = False,
                 k_slots: int | None = None,
                 device="cuda"):
        if words14_feed and time2_feed:
            raise ValueError("words14_feed and time2_feed are exclusive")
        if fused_unpack and time2_feed:
            raise ValueError("fused_unpack and time2_feed are exclusive")
        self.device = resolve_device(device)
        self.n_links = n_links
        self.run_number = run_number
        self.tp_q = QueueSender(capacity=1 << 16)
        # one processor instance per link for header validation + metrics;
        # the device hot path is shared (stacked channels) below.
        # Link l = (WIB slot l//8, stream l%8): the HD APA geometry
        # (utils/channel_map.HDAPAChannelMap), so TPs carry real offline
        # channel numbers and threshold-on-collection zeroes the memory
        # factor on collection-plane channels (WIBEthFrameProcessor.cpp:
        # 441-450).
        self.procs = []
        for link in range(n_links):
            p = WIBEthFrameProcessor(tp_sink=self.tp_q, device=self.device)
            p.conf({"source_id": link, "crate_id": 1, "slot_id": link // 8,
                    "link_id": link % 8, "enable_tpg": True,
                    "tpg_algorithm": algorithm, "tpg_threshold": threshold,
                    "tp_timeout": 100_000,
                    "channel_map_name": channel_map_name,
                    "enable_simple_threshold_on_collection":
                        threshold_on_collection})
            p.start()
            self.procs.append(p)
        self.cfg = self.procs[0].tpg_cfg
        # emission capacity: hits per channel per tc-tick chunk (the JAX
        # app's default 4 — per-channel BURST capacity; overflow is never
        # silent, it lands in the compact trailer's dropped count)
        self.k_slots = 4 if k_slots is None else k_slots

        self.tpset_q = QueueSender(capacity=1 << 16)
        self.handler = TPRequestHandler(
            tpset_sink=self.tpset_q,
            latency_buffer=make_latency_buffer(TP_DTYPE))
        self.handler.conf({"tpset_transmission_rate_hz": 1000,
                           "tpset_min_latency_ticks": 10 * 2048,
                           "tardy_tp_quiet_time_at_start_sec": 0})
        self.handler.start(run_number=run_number)

        # raw retention per link: capacity frames; cleanup trims to half
        # so inserts never hit the hard cap.  Default retention is
        # ZERO-COPY (segment references into the batch slabs process_batch
        # receives — safe because this app never mutates a batch after
        # submission); raw_retention="ring" restores the copying arena.
        self.raw_capacity_frames = int(raw_capacity_frames)
        self.readout = [ReadoutRequestHandler(get_adapter("wibeth"),
                                              capacity=raw_capacity_frames,
                                              retention=raw_retention)
                        for _ in range(n_links)]

        # the feed (module docstring): time2_feed has the HOST unpack and
        # time-pair the ADCs; fused_unpack ships the packed frame words and
        # the kernel unpacks them in-register (K4); words14_feed has the
        # host relayout the words into words14 rows first (K4); neither
        # ships the packed words and unpacks them on the device (K2).
        # State and hits are in canonical channel order on every feed.
        self.words14_feed = words14_feed
        self.time2_feed = time2_feed
        self.fused_unpack = fused_unpack or words14_feed
        self._state = None               # (KSTATE, C) on self.device
        self._dropped_total = 0
        self._feed_buf = native.FeedBuffer()  # host feed output reuse
        self._words_copy_bytes = 0       # bytes copied into words pages
        self.codec_threads = max(1, int(codec_threads))

        # batched whole-APA TP assembly; lookup tables are built lazily
        # after the first batch seeds every processor
        self.batched_assembly = batched_assembly
        self.metrics = MetricsCollector()        # APA-level (batched path)
        self._offline_table = None
        self._det_table = None
        self._mask_sorted = None
        self._assembly_conf_key = None
        # per-link counters accumulate in vectors and flush to the
        # per-proc MetricsCollectors at get_info
        self._hits_link = np.zeros(n_links, dtype=np.int64)
        self._sent_link = np.zeros(n_links, dtype=np.int64)
        self._sendfail_link = np.zeros(n_links, dtype=np.int64)
        # shipped-TP retention bound for the data-request path
        self.handler_max_occupancy = 1 << 20

        # per-batch stage latencies (ms), bounded history (see the JAX app)
        self.batch_timings = deque(maxlen=4096)

        # pipelined (depth-2) batching: process_batch SUBMITS this batch's
        # device work (CUDA launches are asynchronous) and then finishes
        # the PREVIOUS batch (fetch + TP assembly + handler).  FeedBuffer
        # is double-buffered so the previous submit's host feed page is
        # never overwritten while it may still be in use.
        self.pipelined = bool(pipelined)
        self._pending = None
        # on a card, the device time of the TPG launch and of the
        # compaction: (tpg start, tpg end, compact start, compact end) for
        # each of the pipeline's two batches in flight, reused; a slot's
        # times are read after its batch's fetch, before it is recorded
        # again
        self._events = None
        if self.device.type == "cuda":
            self._events = [tuple(torch.cuda.Event(enable_timing=True)
                                  for _ in range(4)) for _ in range(2)]
        self._slot = 0

    # ---- the fused hot path over all links ------------------------------
    def _fetch_hits(self, packed):
        """The one device->host sync: packed compact-hit tensor ->
        (canonical hit array, dropped)."""
        return unpack_compact(packed)

    def _host_feed(self, frames_links: np.ndarray, words: np.ndarray | None):
        """The feed's host stage: the batch's (L, N, 7200) frames, or on
        every feed but time2 their (L, T, 28) packed words -> (int32 host
        array to ship, the ingest function that takes it on the device)."""
        if self.time2_feed:
            # the codec reads each frame's ADC region where it lies;
            # pad8=False: only the ceil(C/128) data rows, which the kernel
            # reads with that row stride, nothing padded on the device
            L, N, _ = frames_links.shape
            return native.relayout_time2_frames(
                frames_links, out=self._feed_buf.get(native.time2_feed_shape(
                    L, N * wibeth.N_TIME_SAMPLES, pad8=False)),
                nthreads=self.codec_threads, pad8=False), process_time2_feed
        L, T, _ = words.shape
        if self.words14_feed:
            # host relayout into the kernel's words14 rows (reused output
            # buffer), unpacked in-register by K4
            return native.relayout_words14(
                words, out=self._feed_buf.get(
                    native.words14_feed_shape(L, T)),
                nthreads=self.codec_threads), process_words14_feed
        # the packed frame words as they are: K4 (fused) or the device
        # unpack and K2
        return words.view(np.int32), (
            process_packed_frames_fused if self.fused_unpack
            else process_packed_frames)

    def _record(self, events, i: int) -> None:
        if events is not None:
            events[i].record(torch.cuda.current_stream(self.device))

    def _device_submit(self, frames_links: np.ndarray, row: dict,
                       events=None):
        """Enqueue one batch's device work and return the (not yet
        fetched) packed compact-hit device tensor; the carried state
        chains on the device between submits.  The stages' spans go into
        ``row``; ``events`` (a card's pipeline slot, or None) are recorded
        around the TPG launch and the compaction."""
        L, N, _ = frames_links.shape
        T = N * wibeth.N_TIME_SAMPLES
        C = L * wibeth.N_CHANNELS
        with span("apa.words", row):
            if self.time2_feed:
                # no words copy: the codec reads the frames in place; tick
                # 0's words are a view, for the first batch's seeding
                words = None
                tick0 = wibeth.adc_region_u32(frames_links[:, 0])[:, 0]
            else:
                words = wibeth.frames_bytes_to_u32(
                    frames_links.reshape(-1, wibeth.FRAME_SIZE)) \
                    .reshape(L, T, 28)
                self._words_copy_bytes += words.nbytes
                tick0 = words[:, 0]
        if self._state is None:
            # seed from each channel's first sample (the JAX app decodes
            # the same tick with its jnp unpack)
            first = wibeth.unpack_14bit(tick0, wibeth.N_CHANNELS,
                                        wibeth.ADC_BITS) \
                .reshape(-1).astype(np.int32)
            # per-channel memory factors from each link's channel map
            # (threshold-on-collection); set by _first_frame_setup, which
            # process_batch runs before the device pass
            rmf = np.concatenate([p.register_memory_factor
                                  for p in self.procs])
            state = seed_chanstate(init_chanstate(C), first, rmf)
            self._state = pack_state(state, C, device=self.device)
        with span("apa.codec", row):
            fed, fn = self._host_feed(frames_links, words)
        with span("apa.h2d", row, "h2d_host_ms"):
            dev_in = torch.from_numpy(fed).to(self.device)
        with span("apa.tpg", row, "tpg_launch_ms"):
            knobs = kernel_knobs(self.cfg)
            tc = auto_tc(T, cap=knobs["tc"])
            self._record(events, 0)
            slots, nclose, self._state = fn(
                dev_in, self._state, self.cfg, C, tc=tc,
                k_slots=self.k_slots, geometry=knobs["geometry"])
            self._record(events, 1)
        # device-side compaction: only the hit list crosses to the host;
        # overflow beyond max_hits is counted in the trailer's dropped field
        with span("apa.compact", row, "compact_launch_ms"):
            self._record(events, 2)
            packed = compact_on_device(slots, nclose, 0, C, max(2048, 2 * C))
            self._record(events, 3)
        # the words page is the copy's: its release (tens of MB) is timed
        # with it, not left to the return
        if words is not None:
            with span("apa.words", row):
                del words, fed
        return packed

    def _batched_preprocess(self, frames_links: np.ndarray):
        """All-links sequence/timestamp validation in one vectorized pass.
        Clean links only get their carried prev-seq/ts updated; a link with
        any anomaly — or still in first-batch seeding, or in emulator mode —
        falls back to the per-link methods.  Returns (ts_matrix, per-link
        fallback mask)."""
        L, N, _ = frames_links.shape
        flat = frames_links.reshape(L * N, wibeth.FRAME_SIZE)
        seq = wibeth.get_header_field(flat, "seq_id").astype(
            np.int64).reshape(L, N)
        ts = wibeth.get_timestamp(flat).astype(np.uint64).reshape(L, N)
        fallback = np.zeros(L, dtype=bool)
        prev_seq = np.empty(L, dtype=np.int64)
        prev_ts = np.empty(L, dtype=np.uint64)
        for l, p in enumerate(self.procs):
            prev_seq[l] = p.previous_seq_id
            prev_ts[l] = p.previous_ts
            fallback[l] = (p.emulator_mode or p._first_seq_check
                           or p._first_ts_check)
        exp_seq = (np.concatenate([prev_seq[:, None], seq[:, :-1]],
                                  axis=1) + 1) & 0xFFF
        fallback |= ((seq - exp_seq) & 0xFFF != 0).any(axis=1)
        dts = ts - np.concatenate([prev_ts[:, None], ts[:, :-1]], axis=1)
        fallback |= (dts != wibeth.EXPECTED_TICK_DIFFERENCE).any(axis=1)
        for l in np.flatnonzero(fallback):
            self.procs[l].sequence_check(frames_links[l])
            self.procs[l].timestamp_check(frames_links[l])
            # emulator-mode checks REWRITE header timestamps (fake_*);
            # re-decode so buffer keys/ts0 see what the frames now carry
            ts[l] = wibeth.get_timestamp(frames_links[l]).astype(np.uint64)
        for l, p in enumerate(self.procs):
            if not fallback[l]:
                p.previous_seq_id = int(seq[l, -1])
                p.previous_ts = int(ts[l, -1])
                p.last_processed_daq_ts = int(ts[l, -1])
        return ts, fallback

    def process_batch(self, frames_links: np.ndarray):
        """frames_links: (L, N, 7200) one batch of N frames per link."""
        L, N, _ = frames_links.shape
        if 2 * N > self.raw_capacity_frames:
            # cleanup trims to capacity/2 AFTER insert, so a batch must fit
            # in the remaining half or its newest frames silently drop
            raise ValueError(
                f"raw_capacity_frames={self.raw_capacity_frames} must be "
                f">= 2x frames per batch ({N}) — raise --raw-capacity")
        row = {}
        t0 = time.perf_counter()
        with span("apa.preprocess", row):
            ts_mat, _ = self._batched_preprocess(frames_links)
            ts0 = ts_mat[:, 0].astype(np.int64)
        with span("apa.retention", row):
            for l in range(L):
                p = self.procs[l]
                frames = frames_links[l]
                if p._first_hit:
                    p._first_frame_setup(
                        frames, wibeth.get_adcs(frames[:1])
                        .reshape(-1, 64)[0].astype(np.int32))
                # raw payloads stay available for trigger data requests
                # (keys precomputed: one header decode already ran above)
                self.readout[l].insert_payloads(frames, keys=ts_mat[l])
                self.readout[l].cleanup(
                    max_occupancy=self.raw_capacity_frames // 2)

        # submit this batch's device work (asynchronous launches — the
        # sync point is the compact-hit fetch in _finish_batch)
        events = None
        if self._events is not None:
            events = self._events[self._slot]
            self._slot ^= 1
        packed = self._device_submit(frames_links, row, events)
        entry = {"packed": packed, "ts0": ts0, "L": L, "N": N, "t0": t0,
                 "row": row, "events": events,
                 "submit_ms": (time.perf_counter() - t0) * 1e3}
        if self.pipelined:
            prev, self._pending = self._pending, entry
            return self._finish_batch(prev) if prev is not None else 0
        return self._finish_batch(entry)

    def _finish_batch(self, e: dict) -> int:
        """Fetch a submitted batch's compact hits (the one device->host
        sync) and run the host TP tail: assembly, handler insert /
        heartbeat / TPSet windowing / cleanup.  Returns the batch's
        dropped count; appends its batch_timings row."""
        L, N, ts0, row = e["L"], e["N"], e["ts0"], e["row"]
        t_finish = time.perf_counter()
        with span("apa.fetch", row):
            hits, dropped = self._fetch_hits(e["packed"])
        events = e["events"]
        if events is not None:
            # the fetch synchronised the stream past both end events
            row["tpg_device_ms"] = events[0].elapsed_time(events[1])
            row["compact_device_ms"] = events[2].elapsed_time(events[3])
        with span("apa.assembly", row):
            self._dropped_total += dropped
            link = hits["channel"] >> 6             # 64 channels per link
            self._hits_link[:L] += np.bincount(link, minlength=L)
            if self.batched_assembly:
                self._assemble_batch(hits, link, ts0, L)
            else:
                for l in range(L):
                    in_link = link == l
                    h = hits[in_link].copy()
                    h["channel"] -= l * 64
                    self.procs[l].process_swtpg_hits(h, int(ts0[l]))
        with span("apa.handler", row):
            # drain TPs into the latency buffer, emit TPSets; the newest
            # frame timestamp anchors the heartbeat clock so zero-TP
            # batches still advance downstream trigger aggregation
            for batch in self.tp_q.drain():
                self.handler.insert_tps(batch)
            self.handler.note_stream_time(
                int(ts0.max()) + (N - 1) * wibeth.EXPECTED_TICK_DIFFERENCE)
            self.handler.send_tp_sets_once()
            self.handler.cleanup(max_occupancy=self.handler_max_occupancy)
        t_end = time.perf_counter()
        # step_ms: the host wall of this batch's own share of the calls,
        # its submit (from its process_batch's start) and this finish, so
        # the row's spans fit inside it; unpipelined that is the whole
        # call, pipelined the halves of two.  total_ms: from its
        # preprocess to its TPSet emission, across both calls pipelined.
        row["step_ms"] = e["submit_ms"] + (t_end - t_finish) * 1e3
        row["total_ms"] = (t_end - e["t0"]) * 1e3
        self.batch_timings.append(row)
        return dropped

    def flush(self) -> int:
        """Finish the in-flight batch (pipelined mode); no-op otherwise."""
        if self._pending is None:
            return 0
        prev, self._pending = self._pending, None
        return self._finish_batch(prev)

    def _assemble_batch(self, hits: np.ndarray, link: np.ndarray,
                        ts0: np.ndarray, L: int) -> None:
        """One vectorized TP assembly over the whole APA batch
        (stream/wibeth.assemble_tps carries the reference semantics)."""
        # TP-policy conf can change between batches; fingerprint it so the
        # batched cache never serves stale conf
        conf_key = tuple((p.tp_algo, p.tp_max_width,
                          frozenset(p.channel_mask_set))
                         for p in self.procs)
        if conf_key != self._assembly_conf_key:
            self._offline_table = None
            self._assembly_conf_key = conf_key
        if self._offline_table is None:
            algos = {p.tp_algo for p in self.procs}
            widths = {p.tp_max_width for p in self.procs}
            if len(algos) > 1 or len(widths) > 1:
                raise ValueError(
                    "batched assembly requires uniform tp_algo/tp_max_width "
                    f"across links (got algos={algos}, widths={widths}); "
                    "use batched_assembly=False for heterogeneous links")
            self._offline_table = np.concatenate(
                [p.register_channels for p in self.procs])
            self._det_table = np.array([p.det_id for p in self.procs],
                                       dtype=np.int64)
            # masks are PER LINK, so match on (link, channel) keys
            masked = [(l, c) for l, p in enumerate(self.procs)
                      for c in p.channel_mask_set]
            self._mask_sorted = (np.sort(np.array(
                [(l << 32) | (c & 0xFFFFFFFF) for l, c in masked],
                dtype=np.int64)) if masked else None)
        tps, kept = assemble_tps(hits, ts0[link], self._offline_table,
                                 self._det_table[link],
                                 self.procs[0].tp_algo)
        kept_link = link[kept]
        # policy layer (mirrors WIBEthFrameProcessor._filter_and_send)
        if self._mask_sorted is not None and len(tps):
            keys = (kept_link.astype(np.int64) << 32) \
                | (tps["channel"].astype(np.int64) & 0xFFFFFFFF)
            keep = ~np.isin(keys, self._mask_sorted)
            tps, kept_link = tps[keep], kept_link[keep]
        too_long = tps["time_over_threshold"] > \
            np.uint64(self.procs[0].tp_max_width)
        n_long = int(too_long.sum())
        if n_long:
            self.metrics.inc("num_tps_suppressed_too_long", n_long)
            tps, kept_link = tps[~too_long], kept_link[~too_long]
        self.metrics.add_channel_tps(tps["channel"])
        if len(tps) == 0:
            return
        sent = self.tp_q.try_send(tps)
        if not sent:
            self.metrics.inc("num_tps_send_failed", len(tps))
        vec = self._sent_link if sent else self._sendfail_link
        vec[:L] += np.bincount(kept_link, minlength=L)

    def latency_info(self, frames_per_batch: int | None = None) -> dict:
        """Data-arrival -> TP-available latency summary over the recorded
        batch history (batch_timings); see the JAX app for the model.

        ``stages_ms_p50`` holds each stage's median: the host spans
        ``preprocess_ms``, ``retention_ms``, ``words_ms``, ``codec_ms``,
        ``h2d_host_ms``, ``tpg_launch_ms``, ``compact_launch_ms``,
        ``fetch_ms``, ``assembly_ms``, ``handler_ms``, and on a card the
        device times ``tpg_device_ms`` and ``compact_device_ms``."""
        if not self.batch_timings:
            return {}
        rows = list(self.batch_timings)
        tot = np.array([r["total_ms"] for r in rows])
        out = {"batches": len(rows),
               "proc_ms_p50": round(float(np.percentile(tot, 50)), 3),
               "proc_ms_p95": round(float(np.percentile(tot, 95)), 3),
               "proc_ms_max": round(float(tot.max()), 3),
               "stages_ms_p50": {
                   k: round(float(np.percentile(
                       [r[k] for r in rows], 50)), 3)
                   for k in rows[0] if k not in ("step_ms", "total_ms")}}
        if frames_per_batch:
            span_ms = frames_per_batch * wibeth.EXPECTED_TICK_DIFFERENCE \
                * 16e-6                      # 16 ns / DTS tick
            lat_p95_ms = span_ms + out["proc_ms_p95"]
            out["batch_span_ms"] = round(span_ms, 3)
            out["latency_ms_p95"] = round(lat_p95_ms, 3)
            out["min_latency_ticks"] = int(np.ceil(
                2.0 * lat_p95_ms * 62_500))  # 2x margin, ticks/ms
        return out

    def request_raw(self, link: int, start_ts: int, end_ts: int):
        """Serve a trigger data request for raw frames on one link."""
        return self.readout[link].request(start_ts, end_ts)

    def record_fragment(self, link: int, start_ts: int, end_ts: int,
                        recorder, trigger_number: int = 0,
                        sequence_number: int = 0):
        """Serve a data request as a Fragment and persist it (the dataflow
        tier's job upstream of the reference; tp/recorder.py)."""
        frag = self.readout[link].request_fragment(
            start_ts, end_ts, run_number=self.run_number,
            trigger_number=trigger_number, source_id=link,
            sequence_number=sequence_number)
        recorder.write(frag)
        return frag

    def _flush_link_counters(self) -> None:
        for vec, name in ((self._hits_link, "num_hits"),
                          (self._sent_link, "num_tps_sent"),
                          (self._sendfail_link, "num_tps_send_failed")):
            for l in np.flatnonzero(vec):
                self.procs[l].metrics.inc(name, int(vec[l]))
            vec[:] = 0

    def get_info(self) -> dict:
        self._flush_link_counters()
        info = {"handler": self.handler.get_info(),
                "tpsets_queued": len(self.tpset_q),
                "raw_buffered": sum(r.occupancy() for r in self.readout)}
        info["total_tps_sent"] = sum(p.metrics.count("num_tps_sent")
                                     for p in self.procs)
        info["total_hits"] = sum(p.metrics.count("num_hits")
                                 for p in self.procs)
        info["ts_errors"] = sum(p.metrics.count("num_ts_errors")
                                for p in self.procs)
        # per-channel closes beyond the K-slot capacity per time chunk
        info["hits_dropped"] = self._dropped_total
        # bytes copied into words pages: 0 on the time2 feed, which reads
        # the frames in place
        info["words_copy_bytes"] = self._words_copy_bytes
        if self.batched_assembly:
            info["apa_top_channels"] = self.metrics.top_channels()
            info["tps_suppressed_too_long"] = self.metrics.count(
                "num_tps_suppressed_too_long")
        return info


def make_batch(rng, n_links: int, frames_per_batch: int, batch: int,
               ts: int, signal_rate: float = 0.02):
    """One emulated batch, as the JAX app's ``main`` makes it: noise around
    900 ADC, Poisson-many 8-tick pulses, perfect headers.  Returns
    ((L, N, 7200) uint8 frames, (L, N, 64, 64) uint16 ADCs)."""
    L, N = n_links, frames_per_batch
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
    adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))).astype(np.uint16)
    n_sig = rng.poisson(signal_rate * L * 64)
    for _ in range(n_sig):
        l, c = rng.integers(0, L), rng.integers(0, 64)
        f, t = rng.integers(0, N), rng.integers(0, 50)
        adcs[l, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[l])
        wibeth.fake_timestamps(frames[l], ts)
        wibeth.fake_seq_ids(frames[l], batch * N)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    return frames, adcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, default=N_LINKS_PER_APA)
    ap.add_argument("--frames-per-batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--algorithm", default="SimpleThreshold")
    ap.add_argument("--threshold", type=int, default=150)
    ap.add_argument("--signal-rate", type=float, default=0.02,
                    help="signals per channel per batch")
    ap.add_argument("--channel-map", default="HDAPAChannelMap")
    ap.add_argument("--threshold-on-collection", action="store_true",
                    help="production config: memoryless RS on collection-"
                         "plane channels")
    ap.add_argument("--codec-threads", type=int, default=1,
                    help="host feed codec std::thread fan-out")
    ap.add_argument("--fused-unpack", action="store_true",
                    help="ship the packed frame words; the kernel unpacks "
                         "them in-register (K4)")
    ap.add_argument("--words14-feed", action="store_true",
                    help="host words14 relayout (native.relayout_words14), "
                         "unpacked in-register (K4)")
    ap.add_argument("--time2-feed", action="store_true",
                    help="host-side unpack + time-pairing "
                         "(native.relayout_time2), the time2 datapath (K1)")
    ap.add_argument("--raw-capacity", type=int, default=4096,
                    help="raw frames retained per link for data requests")
    ap.add_argument("--raw-retention", default="zerocopy",
                    choices=["zerocopy", "ring"])
    ap.add_argument("--pipelined", action="store_true",
                    help="depth-2 batch pipelining")
    ap.add_argument("--per-link-assembly", action="store_true",
                    help="per-link TP assembly instead of the batched one")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernel) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)

    app = APAReadoutApp(n_links=args.links, algorithm=args.algorithm,
                        threshold=args.threshold,
                        channel_map_name=args.channel_map,
                        threshold_on_collection=args.threshold_on_collection,
                        fused_unpack=args.fused_unpack,
                        words14_feed=args.words14_feed,
                        time2_feed=args.time2_feed,
                        codec_threads=args.codec_threads,
                        batched_assembly=not args.per_link_assembly,
                        raw_capacity_frames=args.raw_capacity,
                        raw_retention=args.raw_retention,
                        pipelined=args.pipelined, device=args.device)
    rng = np.random.default_rng(0)
    ts = 0x1000000
    t_wall = time.perf_counter()
    data_seconds = 0.0
    for b in range(args.batches):
        frames, _ = make_batch(rng, args.links, args.frames_per_batch, b, ts,
                               args.signal_rate)
        app.process_batch(frames)
        ts += args.frames_per_batch * 2048
        data_seconds += args.frames_per_batch * 64 * 32 / 62.5e6
    app.flush()                        # drain the in-flight batch, if any
    wall = time.perf_counter() - t_wall
    info = app.get_info()
    info["device"] = str(app.device)
    info["wall_seconds"] = round(wall, 3)
    info["data_seconds"] = round(data_seconds, 4)
    info["end_to_end_rtf"] = round(data_seconds / wall, 3)
    print(json.dumps(info, default=str))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
