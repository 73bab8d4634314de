"""Full-detector composition application on PyTorch/CUDA.

Port of ``fdreadoutlibs_tpu/apps/detector_readout.py:1-327``: the same
composition and host code, with ``device`` in place of the JAX package's
``pallas_interpret``.

One process drives all three frontend families the reference library
serves — horizontal-drift TPC (WIBEth APA), photon-detection (DAPHNE
stream) and vertical-drift top-electronics (TDE) — sharing the
request-handler / fragment layer.  This is the fdreadoutmodules-analogue:
the reference describes itself as the glue between readoutlibs and
fdreadoutmodules (reference docs/README.md:2), where a DAQ application
instantiates one DataLinkHandler per link and every handler plugs into
the same data-request / fragment machinery.  Here the composition is:

  TPC arm:  APAReadoutApp   (apps/apa_readout.py — one device pass per
                             batch over all links; K4 on the fused feed)
  PDS arm:  PDSReadoutApp   (apps/pds_readout.py — one device pass per
                             batch over all links; K2)
  TDE arm:  TDEReadoutArm   (below — per-channel ts checks, SWTPG over
                             complete channel cycles, stream/tde.py;
                             ``models.run_model``, K2 under "pallas")

shared across arms:
  * one global SourceID space (subsystem-offset, so trigger data
    requests and fragments route unambiguously — the reference's
    SourceID::Subsystem field),
  * one FragmentRecorder sink for every arm's fragments,
  * one merged TPSet stream (drain_tpsets), time-ordered across arms —
    what the downstream trigger tier consumes from all subdetectors.

``device="cuda"`` (the default) runs the kernels on every arm and raises
when there is no card; ``device="cpu"`` runs their plain versions (the CPU
tests).  The TDE arm's "scan" backend (the default, as in the JAX package)
is ``ops/scan.py`` on ``device``; "pallas" launches the kernel.

Run:  python -m fdreadoutlibs_tpu_torch.apps.detector_readout --batches 3
      (--fused-unpack for the TPC arm's K4 feed, --tde-backend pallas,
      --pipelined, --record DIR; --device cpu for the plain versions)
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..formats import daphne, tde, wibeth
from ..formats.adapters import get_adapter
from ..formats.trigprim import TP_DTYPE
from ..stream.tde import TDEFrameProcessor
from ..stream.transport import QueueSender
from ..tp.latency_buffer import make_latency_buffer
from ..tp.readout_buffer import ReadoutRequestHandler
from ..tp.recorder import FragmentRecorder
from ..tp.request_handler import TPRequestHandler
from .apa_readout import APAReadoutApp, resolve_device
from .pds_readout import PDSReadoutApp

# global SourceID space: subsystem base + link (reference SourceID has an
# explicit Subsystem enum; fragments carry the global id)
TPC_SOURCE_BASE = 0
PDS_SOURCE_BASE = 1000
TDE_SOURCE_BASE = 2000


class TDEReadoutArm:
    """Vertical-drift TDE links: raw retention + SWTPG + TP windowing.

    The reference's TDE path is TDEFrameProcessor (per-channel timestamp
    continuity) + raw buffering for data requests; TPG-over-TDE is the
    documented superset (stream/tde.py).  One processor per link; the
    SWTPG runs per link over complete 64-channel cycles.
    """

    def __init__(self, n_links: int = 1, threshold: int = 500,
                 backend: str = "scan", run_number: int = 1,
                 det_id: int = 11, raw_capacity_frames: int = 512,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_links = n_links
        self.raw_capacity_frames = int(raw_capacity_frames)
        self.tp_q = QueueSender(capacity=1 << 16)
        self.procs = []
        for link in range(n_links):
            p = TDEFrameProcessor(tp_sink=self.tp_q, device=self.device)
            p.conf({"source_id": TDE_SOURCE_BASE + link,
                    "enable_tpg": True, "tpg_threshold": threshold,
                    "tpg_backend": backend, "det_id": det_id})
            p.start()
            self.procs.append(p)
        self.tpset_q = QueueSender(capacity=1 << 16)
        self.handler = TPRequestHandler(
            tpset_sink=self.tpset_q,
            latency_buffer=make_latency_buffer(TP_DTYPE))
        self.handler.conf({"source_id": TDE_SOURCE_BASE,
                           "tpset_transmission_rate_hz": 1000,
                           "tpset_min_latency_ticks":
                               tde.EXPECTED_TICK_DIFFERENCE,
                           "tardy_tp_quiet_time_at_start_sec": 0})
        self.handler.start(run_number=run_number)
        self.readout = [ReadoutRequestHandler(get_adapter("tde"),
                                              capacity=self.raw_capacity_frames)
                        for _ in range(n_links)]
        self.handler_max_occupancy = 1 << 20

    def process_batch(self, frames_links: np.ndarray) -> None:
        """frames_links: (L, N, FRAME_SIZE) — N interleaved channel frames
        per link (complete cycles: N a multiple of the active channel
        count, the link's natural cadence)."""
        L, N, _ = frames_links.shape
        if 2 * N > self.raw_capacity_frames:
            raise ValueError(
                f"raw_capacity_frames={self.raw_capacity_frames} must be "
                f">= 2x frames per batch ({N})")
        newest = 0
        for l in range(L):
            self.readout[l].insert_payloads(frames_links[l])
            self.readout[l].cleanup(
                max_occupancy=self.raw_capacity_frames // 2)
            self.procs[l].process(frames_links[l])
            newest = max(newest, self.procs[l].last_processed_daq_ts)
        for batch in self.tp_q.drain():
            self.handler.insert_tps(batch)
        self.handler.note_stream_time(newest
                                      + tde.EXPECTED_TICK_DIFFERENCE - 1)
        self.handler.send_tp_sets_once()
        self.handler.cleanup(max_occupancy=self.handler_max_occupancy)

    def request_raw(self, link: int, start_ts: int, end_ts: int):
        return self.readout[link].request(start_ts, end_ts)

    def get_info(self) -> dict:
        return {"handler": self.handler.get_info(),
                "tpsets_queued": len(self.tpset_q),
                "raw_buffered": sum(r.occupancy() for r in self.readout),
                "total_hits": sum(p.metrics.count("num_hits")
                                  for p in self.procs),
                "total_tps_sent": sum(p.metrics.count("num_tps_sent")
                                      for p in self.procs),
                "ts_errors": sum(p.metrics.count("num_ts_errors")
                                 for p in self.procs)}


class DetectorReadoutApp:
    """TPC + PDS + TDE arms behind one request/fragment surface."""

    def __init__(self, apa_links: int = 8, pds_links: int = 4,
                 tde_links: int = 1, run_number: int = 1,
                 tpc_threshold: int = 150, pds_threshold: int = 60,
                 tde_threshold: int = 500, tde_backend: str = "scan",
                 pipelined: bool = False,
                 device="cuda", **apa_kwargs):
        self.run_number = run_number
        # pipelined threads into BOTH device arms: with depth-2 batching
        # the TPC and PDS device batches are in flight simultaneously and
        # overlap each other's host stages plus the TDE arm's host stages
        self.tpc = APAReadoutApp(n_links=apa_links, run_number=run_number,
                                 threshold=tpc_threshold,
                                 pipelined=pipelined, device=device,
                                 **apa_kwargs)
        self.pds = PDSReadoutApp(n_links=pds_links, run_number=run_number,
                                 threshold=pds_threshold,
                                 pipelined=pipelined, device=device)
        self.tde = TDEReadoutArm(n_links=tde_links, run_number=run_number,
                                 threshold=tde_threshold,
                                 backend=tde_backend, device=device)
        self.device = self.tpc.device
        # per-arm TPSet origins so the merged stream stays attributable
        self.tpc.handler.source_id = TPC_SOURCE_BASE
        self.pds.handler.source_id = PDS_SOURCE_BASE
        self._arms = {"tpc": self.tpc, "pds": self.pds, "tde": self.tde}
        self._bases = {"tpc": TPC_SOURCE_BASE, "pds": PDS_SOURCE_BASE,
                       "tde": TDE_SOURCE_BASE}

    # -- per-arm ingestion (each arm keeps its native batch shape) -------
    def process_tpc_batch(self, frames_links: np.ndarray):
        return self.tpc.process_batch(frames_links)

    def process_pds_batch(self, superchunks: np.ndarray):
        return self.pds.process_batch(superchunks)

    def process_tde_batch(self, frames_links: np.ndarray):
        return self.tde.process_batch(frames_links)

    # -- shared request-handler / fragment layer -------------------------
    def resolve_source(self, source_id: int):
        """Global SourceID -> (subsystem, arm, local link)."""
        for name in ("tde", "pds", "tpc"):   # descending bases
            base = self._bases[name]
            if source_id >= base:
                arm = self._arms[name]
                link = source_id - base
                if link >= arm.n_links:
                    raise KeyError(f"source_id {source_id}: link {link} "
                                   f"out of range for {name}")
                return name, arm, link
        raise KeyError(f"unroutable source_id {source_id}")

    def request_raw(self, source_id: int, start_ts: int, end_ts: int):
        """Windowed trigger data request, routed by global SourceID."""
        _, arm, link = self.resolve_source(source_id)
        return arm.readout[link].request(start_ts, end_ts)

    def record_fragment(self, source_id: int, start_ts: int, end_ts: int,
                        recorder, trigger_number: int = 0,
                        sequence_number: int = 0):
        """Serve a data request as a Fragment into the shared recorder."""
        _, arm, link = self.resolve_source(source_id)
        frag = arm.readout[link].request_fragment(
            start_ts, end_ts, run_number=self.run_number,
            trigger_number=trigger_number, source_id=source_id,
            sequence_number=sequence_number)
        recorder.write(frag)
        return frag

    def flush(self) -> None:
        """Finish the in-flight device batches (pipelined mode); no-op
        otherwise.  Call before the final drain_tpsets/get_info."""
        self.tpc.flush()
        self.pds.flush()

    def drain_tpsets(self) -> list:
        """Merged, time-ordered TPSet stream across all arms — what the
        downstream trigger tier consumes from the whole detector."""
        sets = []
        for arm in self._arms.values():
            sets.extend(arm.tpset_q.drain())
        sets.sort(key=lambda s: (s.start_time, s.origin, s.seqno))
        return sets

    def get_info(self) -> dict:
        return {name: arm.get_info() for name, arm in self._arms.items()}


def _tde_cycle(rng, n_links: int, ts: int, pulse: bool) -> np.ndarray:
    """One complete 64-channel cycle of TDE frames per link."""
    C, S = tde.N_CHANNELS_PER_LINK, tde.TOT_ADC16_SAMPLES
    frames = np.stack([tde.empty_frames(C) for _ in range(n_links)])
    for l in range(n_links):
        tde.set_channel(frames[l], np.arange(C))
        tde.set_timestamp(frames[l], np.full(C, ts, dtype=np.uint64))
        samples = (8000 + rng.normal(0, 20, size=(C, S))).astype(np.uint16)
        if pulse:
            c, t0 = rng.integers(0, C), rng.integers(100, S - 100)
            samples[c, t0:t0 + 12] += np.uint16(3000)
        tde.set_adc_samples(frames[l], samples)
    return frames


def _tpc_batch(rng, n_links: int, n_frames: int, batch: int,
               ts: int) -> np.ndarray:
    """One batch of WIBEth frames per link as the JAX app's ``main`` makes
    it: noise around 900 ADC and Poisson(2) 8-tick pulses."""
    L, N = n_links, n_frames
    frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
    adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))).astype(np.uint16)
    for _ in range(rng.poisson(2)):
        l, c = rng.integers(0, L), rng.integers(0, 64)
        f, t = rng.integers(0, N), rng.integers(0, 50)
        adcs[l, f, t:t + 8, c] += np.uint16(rng.integers(400, 3000))
    for l in range(L):
        wibeth.set_adcs(frames[l], adcs[l])
        wibeth.fake_timestamps(frames[l], ts)
        wibeth.fake_seq_ids(frames[l], batch * N)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    return frames


def _pds_batch(rng, n_links: int, n_superchunks: int, ts: int):
    """One batch of DAPHNE-stream superchunks per link as the JAX app's
    ``main`` makes it: noise around 700 ADC, a 20-tick LED-like pulse on
    half the links.  Returns (superchunks, ticks per link)."""
    Lp, M = n_links, n_superchunks
    scs = np.stack([daphne.empty_superchunks(M, stream=True)
                    for _ in range(Lp)])
    dfr = daphne.superchunk_frames(scs, stream=True)
    T = M * daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
    padcs = (700 + rng.normal(0, 8, size=(Lp, T, 4))).astype(np.uint16)
    for l in range(Lp):
        if rng.random() < 0.5:
            t0 = rng.integers(0, T - 40)
            padcs[l, t0:t0 + 20, rng.integers(0, 4)] += np.uint16(1500)
        daphne.stream_set_adcs(
            dfr[l].reshape(-1, daphne.STREAM_FRAME_SIZE),
            padcs[l].reshape(-1, daphne.STREAM_N_SAMPLES, 4))
        daphne.fake_timestamps(scs[l], ts, offset=64, stream=True)
    return scs, T


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apa-links", type=int, default=8)
    ap.add_argument("--pds-links", type=int, default=4)
    ap.add_argument("--tde-links", type=int, default=1)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--frames-per-batch", type=int, default=8,
                    help="WIBEth frames per TPC link per batch")
    ap.add_argument("--tde-backend", default="scan")
    ap.add_argument("--fused-unpack", action="store_true",
                    help="the TPC arm ships the packed frame words; the "
                         "kernel unpacks them in-register (K4)")
    ap.add_argument("--pipelined", action="store_true",
                    help="depth-2 batch pipelining on the TPC and PDS "
                         "device arms (see apa_readout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--record", default=None,
                    help="directory: record one fragment per arm at the end")
    args = ap.parse_args(argv)

    app = DetectorReadoutApp(apa_links=args.apa_links,
                             pds_links=args.pds_links,
                             tde_links=args.tde_links,
                             tde_backend=args.tde_backend,
                             pipelined=args.pipelined,
                             device=args.device,
                             fused_unpack=args.fused_unpack)
    rng = np.random.default_rng(7)
    ts_tpc, ts_pds, ts_tde = 0x1000000, 0x2000000, 0x3000000
    t_wall = time.perf_counter()
    n_tpsets = 0
    for b in range(args.batches):
        # TPC: WIBEth noise + occasional pulses
        N = args.frames_per_batch
        app.process_tpc_batch(_tpc_batch(rng, args.apa_links, N, b, ts_tpc))
        ts_tpc += N * 2048

        # PDS: DAPHNE-stream superchunks with LED-like pulses
        scs, T = _pds_batch(rng, args.pds_links, 4, ts_pds)
        app.process_pds_batch(scs)
        ts_pds += T

        # TDE: one complete channel cycle per link
        app.process_tde_batch(_tde_cycle(rng, args.tde_links, ts_tde,
                                         pulse=True))
        ts_tde += tde.EXPECTED_TICK_DIFFERENCE

        n_tpsets += len(app.drain_tpsets())

    app.flush()                        # drain in-flight batches, if any
    n_tpsets += len(app.drain_tpsets())
    info = app.get_info()
    info["merged_tpsets"] = n_tpsets
    if args.record:
        rec = FragmentRecorder(args.record, run_number=1)
        for sid, (t0, t1) in ((TPC_SOURCE_BASE, (0x1000000, ts_tpc)),
                              (PDS_SOURCE_BASE, (0x2000000, ts_pds)),
                              (TDE_SOURCE_BASE, (0x3000000, ts_tde))):
            app.record_fragment(sid, t0, t1, rec)
        info["fragments_recorded"] = len(rec)
    info["device"] = str(app.device)
    info["wall_seconds"] = round(time.perf_counter() - t_wall, 3)
    print(json.dumps(info, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
