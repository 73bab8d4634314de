"""PDS (DAPHNE-stream) readout application on PyTorch/CUDA — the
photon-detector sibling of apa_readout.

Port of ``fdreadoutlibs_tpu/apps/pds_readout.py:1-283``.  Every host stage
is the JAX package's code; only the device seam differs:

  emulated DAPHNE-stream sources (L links, 4 ch x 64 samples per frame)
    -> per-link timestamp validation (DAPHNEStreamFrameProcessor checks)
    -> raw superchunk retention per link (ReadoutRequestHandler with the
       "daphne_stream" adapter; serves DAPHNEListRequestHandler-style
       windowed data requests)
    -> ONE host-to-device copy of the packed 14-bit ADC words of all
       links, the torch unpack on the device and the hand-written CUDA TPG
       kernel (K2, the plain-sample datapath) over all links' channels,
       stacked as link*4 + c (ops/ingest.process_packed_daphne), on-device
       compaction
    -> ONE device-to-host fetch of the compact hit list
    -> one vectorized PDS TP assembly over the whole batch (1 clock/tick)
    -> TP latency buffer + TPSet windowing with cutoff/heartbeats

The reference runs NO trigger-primitive generation on the PDS stream —
its DAPHNE path is raw buffering + list requests only
(src/daphne/DAPHNEListRequestHandler.cpp); the SWTPG-over-PDS pipeline
here is a documented superset (stream/daphne.py find_hits docstring).
TP times use one 62.5 MHz clock per sample (the DAPHNE stream frame
cadence: 64 ticks per frame, DAPHNEStreamSuperChunkTypeAdapter.hpp).

``device="cuda"`` (the default) runs the kernel and raises when there is no
card; ``device="cpu"`` runs the kernel's plain version (the CPU tests).
Nothing falls back from one to the other.

Run:  python -m fdreadoutlibs_tpu_torch.apps.pds_readout --links 10 \\
          --batches 8   (--pipelined; --device cpu for the plain version)
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..formats import daphne
from ..formats.adapters import get_adapter
from ..formats.bitpack import unpack_14bit
from ..formats.trigprim import TP_DTYPE, TPAlgorithm, TPType, ts_to_i64
from ..ops import TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.ingest import (compact_on_device, process_packed_daphne,
                          unpack_compact)
from ..ops.tpg import auto_tc, pack_state
from ..stream.daphne import DAPHNEStreamFrameProcessor
from ..stream.transport import QueueSender
from ..tp.latency_buffer import make_latency_buffer
from ..tp.readout_buffer import ReadoutRequestHandler
from ..tp.request_handler import TPRequestHandler
from ..utils.metrics import MetricsCollector
from ..utils.tuning import kernel_knobs
from .apa_readout import resolve_device

CH_PER_LINK = daphne.STREAM_N_CHANNELS          # 4
TICKS_PER_SC = daphne.STREAM_EXPECTED_TICK_DIFFERENCE \
    * daphne.STREAM_FRAMES_PER_SUPERCHUNK       # 768
TICK_S = 16e-9                                  # one 62.5 MHz clock


class PDSReadoutApp:
    """Multi-link PDS readout with a single fused device hot path."""

    def __init__(self, n_links: int = 10,
                 algorithm: str = "SimpleThreshold", threshold: int = 60,
                 run_number: int = 1, det_id: int = 2,
                 raw_capacity_superchunks: int = 1024,
                 pipelined: bool = False,
                 k_slots: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_links = n_links
        # None -> 4, the capacity-driven streaming default (rationale on
        # APAReadoutApp.k_slots)
        self.k_slots = 4 if k_slots is None else k_slots
        self.run_number = run_number
        self.det_id = det_id
        self.cfg = TPGConfig.from_raw(algorithm=algorithm,
                                      threshold=threshold)
        # per-link processors carry the timestamp checks + error metrics;
        # the TPG itself runs once for all links below
        self.procs = []
        for link in range(n_links):
            p = DAPHNEStreamFrameProcessor(device=self.device)
            p.conf({"source_id": link})
            p.start()
            self.procs.append(p)

        self.tpset_q = QueueSender(capacity=1 << 16)
        self.handler = TPRequestHandler(
            tpset_sink=self.tpset_q,
            latency_buffer=make_latency_buffer(TP_DTYPE))
        self.handler.conf({"tpset_transmission_rate_hz": 1000,
                           "tpset_min_latency_ticks": 4 * TICKS_PER_SC,
                           "tardy_tp_quiet_time_at_start_sec": 0})
        self.handler.start(run_number=run_number)

        self.raw_capacity = int(raw_capacity_superchunks)
        self.readout = [ReadoutRequestHandler(get_adapter("daphne_stream"),
                                              capacity=self.raw_capacity)
                        for _ in range(n_links)]
        self.metrics = MetricsCollector()
        self._stack = None               # (KSTATE, C) on self.device
        self._dropped_total = 0
        self.handler_max_occupancy = 1 << 20
        # depth-2 pipelined batching, same contract as apa_readout:
        # process_batch submits this batch's device work (asynchronous
        # launches) and finishes the previous one; flush() drains the tail
        self.pipelined = bool(pipelined)
        self._pending = None

    # ---- fused hot path over all links ----------------------------------
    def _device_pass(self, words: np.ndarray):
        """words: (L, N, 112) packed ADC rows -> (hits over L*4 global
        channels, dropped)."""
        return self._fetch_hits(self._device_submit(words))

    def _fetch_hits(self, packed):
        """The one device->host sync: packed compact-hit tensor ->
        (canonical hit array, dropped)."""
        return unpack_compact(packed)

    def _device_submit(self, words: np.ndarray):
        """Enqueue one batch's device work; returns the un-fetched packed
        compact-hit device tensor (asynchronous launches — the carried
        state chains on the device between submits)."""
        L, N, _ = words.shape
        C = L * CH_PER_LINK
        T = N * daphne.STREAM_N_SAMPLES
        knobs = kernel_knobs(self.cfg)
        if self._stack is None:
            first = unpack_14bit(words[:, 0], CH_PER_LINK
                                 * daphne.STREAM_N_SAMPLES, daphne.ADC_BITS) \
                .reshape(L, daphne.STREAM_N_SAMPLES, CH_PER_LINK)[:, 0] \
                .reshape(C).astype(np.int32)
            self._stack = pack_state(
                seed_chanstate(init_chanstate(C), first,
                               self.cfg.rs_memory_factor_x10),
                C, device=self.device)
        tc = auto_tc(T, cap=knobs["tc"])
        dev_words = torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(self.device)
        slots, nclose, self._stack = process_packed_daphne(
            dev_words, self._stack, self.cfg, C, tc=tc,
            k_slots=self.k_slots, fir_twopass=knobs["fir_twopass"],
            geometry=knobs["geometry"])
        return compact_on_device(slots, nclose, 0, C, max(2048, 2 * C))

    def process_batch(self, superchunks: np.ndarray):
        """superchunks: (L, M, 5664) one batch of M superchunks per link."""
        L, M, _ = superchunks.shape
        if 2 * M > self.raw_capacity:
            raise ValueError(
                f"raw_capacity_superchunks={self.raw_capacity} must be "
                f">= 2x superchunks per batch ({M})")
        ts0 = np.zeros(L, dtype=np.int64)
        for l in range(L):
            p = self.procs[l]
            p.timestamp_check(superchunks[l])
            ts0[l] = ts_to_i64(daphne.get_first_timestamp(
                superchunks[l][:1], stream=True)[0])
            self.readout[l].insert_payloads(superchunks[l])
            self.readout[l].cleanup(max_occupancy=self.raw_capacity // 2)

        frames = daphne.superchunk_frames(superchunks, stream=True) \
            .reshape(L, -1, daphne.STREAM_FRAME_SIZE)
        words = daphne.stream_frames_bytes_to_u32(frames)
        packed = self._device_submit(words)
        if self.pipelined:
            prev, self._pending = self._pending, (packed, ts0, M)
            return self._finish_batch(*prev) if prev is not None else 0
        return self._finish_batch(packed, ts0, M)

    def _finish_batch(self, packed, ts0: np.ndarray, M: int) -> int:
        hits, dropped = self._fetch_hits(packed)
        self._dropped_total += dropped
        self.metrics.inc("num_hits", len(hits))
        self._assemble_batch(hits, ts0)
        self.handler.note_stream_time(
            int(ts0.max()) + M * TICKS_PER_SC - 1)
        self.handler.send_tp_sets_once()
        self.handler.cleanup(max_occupancy=self.handler_max_occupancy)
        return dropped

    def flush(self) -> int:
        """Finish the in-flight batch (pipelined mode); no-op otherwise."""
        if self._pending is None:
            return 0
        prev, self._pending = self._pending, None
        return self._finish_batch(*prev)

    def _assemble_batch(self, hits: np.ndarray, ts0: np.ndarray) -> None:
        """Vectorized PDS hit->TP assembly for the whole batch: one clock
        per sample (stream/daphne.py find_hits semantics), channel =
        link*4 + c (the global stacking of the fused kernel)."""
        if len(hits) == 0:
            return
        link = hits["channel"] >> 2
        t_begin = ts0[link] + hits["end_tick"].astype(np.int64) \
            - hits["tover"].astype(np.int64)
        tps = np.zeros(len(hits), dtype=TP_DTYPE)
        tps["time_start"] = t_begin.astype(np.uint64)
        tps["time_peak"] = (t_begin + hits["peak_time"]).astype(np.uint64)
        tps["time_over_threshold"] = hits["tover"]
        tps["channel"] = hits["channel"]
        tps["adc_integral"] = hits["charge"]
        tps["adc_peak"] = hits["peak_adc"]
        tps["detid"] = self.det_id
        tps["type"] = TPType.kPDS
        tps["algorithm"] = TPAlgorithm.kSimpleThreshold
        tps["version"] = 1
        self.metrics.add_channel_tps(tps["channel"])
        self.handler.insert_tps(tps)
        self.metrics.inc("num_tps_sent", len(tps))

    def request_raw(self, link: int, start_ts: int, end_ts: int):
        return self.readout[link].request(start_ts, end_ts)

    def get_info(self) -> dict:
        return {"handler": self.handler.get_info(),
                "tpsets_queued": len(self.tpset_q),
                "raw_buffered": sum(r.occupancy() for r in self.readout),
                "total_hits": self.metrics.count("num_hits"),
                "total_tps_sent": self.metrics.count("num_tps_sent"),
                "ts_errors": sum(p.metrics.count("num_ts_errors")
                                 for p in self.procs),
                "hits_dropped": self._dropped_total,
                "pds_top_channels": self.metrics.top_channels()}


def make_batch(rng, n_links: int, superchunks_per_batch: int, ts: int,
               signal_rate: float = 0.3):
    """One emulated batch, as the JAX app's ``main`` makes it: noise around
    700 ADC, LED-like 20-tick pulses with probability ``signal_rate`` per
    channel, timestamps +64 per frame from ``ts``.  Returns ((L, M, 5664)
    uint8 superchunks, (L, T, 4) uint16 ADCs), T = 768 M."""
    L, M = n_links, superchunks_per_batch
    scs = np.stack([daphne.empty_superchunks(M, stream=True)
                    for _ in range(L)])
    frames = daphne.superchunk_frames(scs, stream=True)
    T = M * daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
    adcs = (700 + rng.normal(0, 8, size=(L, T, CH_PER_LINK))) \
        .astype(np.uint16)
    for l in range(L):
        for c in range(CH_PER_LINK):
            if rng.random() < signal_rate:
                t0 = rng.integers(0, T - 40)
                adcs[l, t0:t0 + 20, c] += np.uint16(rng.integers(200, 2000))
    for l in range(L):
        daphne.stream_set_adcs(
            frames[l].reshape(-1, daphne.STREAM_FRAME_SIZE),
            adcs[l].reshape(-1, daphne.STREAM_N_SAMPLES, CH_PER_LINK))
        daphne.fake_timestamps(scs[l], ts, offset=64, stream=True)
    return scs, adcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, default=10)
    ap.add_argument("--superchunks-per-batch", type=int, default=4)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--threshold", type=int, default=60)
    ap.add_argument("--signal-rate", type=float, default=0.3,
                    help="LED-pulse probability per channel per batch")
    ap.add_argument("--pipelined", action="store_true",
                    help="depth-2 batch pipelining (see apa_readout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernel) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)

    app = PDSReadoutApp(n_links=args.links, threshold=args.threshold,
                        pipelined=args.pipelined, device=args.device)
    rng = np.random.default_rng(3)
    ts = 0x2000000
    t_wall = time.perf_counter()
    data_seconds = 0.0
    for _ in range(args.batches):
        scs, adcs = make_batch(rng, args.links, args.superchunks_per_batch,
                               ts, args.signal_rate)
        app.process_batch(scs)
        T = adcs.shape[1]
        ts += T
        data_seconds += T * TICK_S
    app.flush()                        # drain the in-flight batch, if any
    wall = time.perf_counter() - t_wall
    info = app.get_info()
    info["device"] = str(app.device)
    info["wall_seconds"] = round(wall, 3)
    info["data_seconds"] = round(data_seconds, 5)
    info["end_to_end_rtf"] = round(data_seconds / wall, 4)
    print(json.dumps(info, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
