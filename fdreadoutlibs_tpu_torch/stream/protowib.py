"""ProtoWIB frame processor — the legacy FIR+IQR dual-plane pipeline.

Port copy of ``fdreadoutlibs_tpu/stream/protowib.py``: the same checks and
TP assembly; the device seam (``_run_pallas_packed``,
``_run_pallas_time2``) runs the port's ``ops.ingest`` on an explicit
``device`` ("cuda" by default, which raises without a card; "cpu" runs the
kernels' plain versions).  ``tpg_backend`` is "pallas" (the default, and
what "auto" means: the kernel route, as the port's WIBEth processor
defaults to its kernel route), "reference" (the numpy oracle) or "scan"
(``ops/scan.py``, the port's one scan, through ``models.run_model``).
Each plane runs the FIR schedule that ``utils.tuning.kernel_knobs``
names: the fused tick (K3) or, under a tuned ``twopass`` of 1 or 2, the
two-pass schedule (K5).

Equivalent of WIBFrameProcessor (include/fdreadoutlibs/wib/
WIBFrameProcessor.hpp; excluded from the reference *build* but fully
specified): preprocess = timestamp_check (delta 25/frame, 300/superchunk,
hpp:352-394) + frame_error_check (16 wib_errors bits with rate-limited
errored-frame forwarding, hpp:399-438); postprocess = FIR+IQR hit finding
with the collection/induction plane split.

The reference runs collection (6 registers) on the caller thread and
induction (10 registers) on a pinned spin-waiting thread (hpp:455-459,
545-584).  Here both planes are column gathers of one device decode, run
as two kernel launches only to honour the separate per-plane thresholds.

Hits feed the legacy WIBTPHandler (fixed aligned TPSet windows) rather
than the TPCTPRequestHandler path (hpp:665-667).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..formats import protowib
from ..formats.trigprim import TP_DTYPE, TPAlgorithm, TPType, ts_to_i64
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.config import Algorithm, TPGConfig
from ..ops.ingest import (collect_hits, process_packed_protowib,
                          process_time2_feed)
from ..ops.tpg import auto_tc, pack_state
from ..tp.wib_tp_handler import WIBTPHandler
from ..utils.tuning import kernel_knobs
from .errors import ErrorInterval
from .processor import TaskRawDataProcessor

CLOCKS_PER_TPC_TICK = 25     # 2 MHz @ 50 MHz clock (hpp:586-590)
BACKENDS = ("pallas", "reference", "scan")


class WIBFrameProcessor(TaskRawDataProcessor):

    def __init__(self, error_registry=None, tp_handler: WIBTPHandler | None = None,
                 errored_frame_sink=None, device="cuda"):
        super().__init__(error_registry)
        # the apps module imports the stream package, so resolve_device
        # comes late
        from ..apps.apa_readout import resolve_device
        self.device = resolve_device(device)
        self.tp_handler = tp_handler
        self.errored_frame_sink = errored_frame_sink
        self.tpg_enabled = False
        self.backend = "pallas"

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.crate_no = config.get("crate_id", 0)
        self.slot_no = config.get("slot_id", 0)
        self.fiber_no = config.get("link_id", 0)
        # "auto" (RawDataProcessorConf's default) is the kernel route
        self.backend = config.get("tpg_backend", "pallas")
        if self.backend == "auto":
            self.backend = "pallas"
        if self.backend not in BACKENDS:
            raise ValueError(f"tpg_backend {self.backend!r}: expected one of "
                             f"{BACKENDS}")
        # per-plane thresholds in sigma units (hpp:724: m_coll_threshold=5)
        self.coll_threshold = config.get("tpg_collection_threshold", 5)
        self.ind_threshold = config.get("tpg_induction_threshold", 5)
        self.min_collection_offline = config.get("min_collection_offline", 9472)
        self.min_induction_offline = config.get("min_induction_offline", 7680)
        self.error_counter_threshold = config.get("error_counter_threshold",
                                                  100)
        self.k_slots = config.get(
            "tpg_k_slots", config.get("tpg_pallas_k_slots", 4))
        self._device_compact = bool(config.get("tpg_device_compact", True))
        self._max_hits = config.get("tpg_max_hits")
        # time2 feed: the HOST decodes the 12-bit nibble codec and pairs
        # two ticks per int32 word (native.relayout_time2_protowib); the
        # device runs the time2 FIR datapath (pallas backend only)
        self._time2_feed = bool(config.get("tpg_time2_feed", False))

        self.add_preprocess_task(self.timestamp_check)
        self.add_preprocess_task(self.frame_error_check)
        if config.get("enable_tpg", config.get("enable_software_tpg", False)):
            self.tpg_enabled = True
            self.add_postprocess_task(self.find_hits)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = 0
        self._first_ts_check = True
        self._first_hit = True
        self._frames_processed = 0
        self._error_occurrence = np.zeros(16, dtype=np.int64)
        self._coll_stack = None
        self._ind_stack = None
        self._coll_state = None
        self._ind_state = None
        self._t2_buf_coll = native.FeedBuffer()   # time2 feed output reuse
        self._t2_buf_ind = native.FeedBuffer()
        coll_off, ind_off = protowib.register_offline_channels(
            self.min_collection_offline, self.min_induction_offline)
        self.collection_offlines = coll_off
        self.induction_offlines = ind_off
        if self.tp_handler is not None:
            self.tp_handler.reset()

    # ------------------------------------------------------------ checks
    def timestamp_check(self, superchunks: np.ndarray) -> None:
        if superchunks.shape[0] == 0:
            return
        tick = protowib.SUPERCHUNK_TICK_DIFFERENCE     # 300
        frames = protowib.superchunk_frames(superchunks)
        if self.emulator_mode:
            first = (self.previous_ts + tick) if not self._first_ts_check else \
                int(protowib.get_timestamp(frames[0, :1])[0])
            protowib.fake_timestamps(superchunks, first)
        ts = protowib.get_timestamp(frames[:, 0]).astype(np.uint64)
        prev = np.concatenate([[np.uint64(self.previous_ts)], ts[:-1]])
        ok = (ts - prev) == tick
        if self._first_ts_check:
            ok[0] = True
            self._first_ts_check = False
        bad = np.nonzero(~ok)[0]
        if len(bad):
            self.metrics.inc("num_ts_errors", len(bad))
            for i in bad[:16]:
                self.error_registry.add_error(
                    "MISSING_FRAMES", ErrorInterval(int(prev[i]) + tick,
                                                    int(ts[i])))
        self.previous_ts = int(ts[-1])
        self.last_processed_daq_ts = int(ts[-1])

    def frame_error_check(self, superchunks: np.ndarray) -> None:
        """16 WIB error bits per frame (hpp:399-438).  num_frame_errors
        counts set bits (m_frame_error_count += popcount, hpp:415-417).
        Errored-frame forwarding is gated by per-bit occurrence counters:
        each bit may forward frames while its counter < threshold, with a
        leaky decay of 1 per bit every 10000 frames processed
        (hpp:406-410, 419-432)."""
        flat = protowib.superchunk_frames(superchunks) \
            .reshape(-1, protowib.FRAME_SIZE)
        errs = protowib.get_wib_errors(flat)
        n = len(flat)
        f0 = self._frames_processed
        self._frames_processed = f0 + n
        bad = np.nonzero(errs != 0)[0]
        next_decay = -(-f0 // 10000) * 10000       # first g >= f0, g%10000==0
        if len(bad):
            bits_matrix = (errs[bad, None] >> np.arange(16)) & 1
            self.metrics.inc("num_frame_errors", int(bits_matrix.sum()))
            for bit in range(16):
                n_bit = int(bits_matrix[:, bit].sum())
                if n_bit:
                    self.metrics.inc(f"num_frame_errors_bit{bit}", n_bit)
            forward = []
            for pos, i in enumerate(bad):
                g = f0 + int(i)
                while next_decay <= g:
                    np.maximum(self._error_occurrence - 1, 0,
                               out=self._error_occurrence)
                    next_decay += 10000
                pushed = False
                for j in np.nonzero(bits_matrix[pos])[0]:
                    if self._error_occurrence[j] < self.error_counter_threshold:
                        self._error_occurrence[j] += 1
                        pushed = True
                if pushed:
                    forward.append(i)
            if forward and self.errored_frame_sink is not None:
                self.errored_frame_sink.try_send(flat[forward].copy())
        # decay points in the tail of the batch still apply
        while next_decay < f0 + n:
            np.maximum(self._error_occurrence - 1, 0,
                       out=self._error_occurrence)
            next_decay += 10000

    # --------------------------------------------------------------- TPG
    def _seed(self, adcs0: np.ndarray) -> None:
        coll0 = adcs0[protowib.COLLECTION_INDEX_TO_CHAN]
        ind0 = adcs0[protowib.INDUCTION_INDEX_TO_CHAN]
        self.coll_cfg = TPGConfig(algorithm=Algorithm.FIR,
                                  threshold=self.coll_threshold,
                                  track_peaks=False)
        self.ind_cfg = TPGConfig(algorithm=Algorithm.FIR,
                                 threshold=self.ind_threshold,
                                 track_peaks=False)
        self._coll_state = seed_chanstate(
            init_chanstate(protowib.N_COLLECTION), coll0, 0)
        self._ind_state = seed_chanstate(
            init_chanstate(protowib.N_INDUCTION), ind0, 0)
        self._first_hit = False

    def find_hits(self, superchunks: np.ndarray) -> None:
        if superchunks.shape[0] == 0:
            return
        frames = protowib.superchunk_frames(superchunks)
        flat = frames.reshape(-1, protowib.FRAME_SIZE)
        timestamp = int(protowib.get_timestamp(flat[:1])[0])
        T = flat.shape[0]
        if self._first_hit:
            self._seed(protowib.get_adcs(flat[:1])[0].astype(np.int32))

        if self.backend == "pallas":
            h_coll, h_ind = (self._run_pallas_time2(flat)
                             if self._time2_feed
                             else self._run_pallas_packed(flat))
        else:
            adcs = protowib.get_adcs(flat).astype(np.int32)
            coll = adcs[:, protowib.COLLECTION_INDEX_TO_CHAN]
            ind = adcs[:, protowib.INDUCTION_INDEX_TO_CHAN]
            h_coll, self._coll_state = self._run(coll, self._coll_state,
                                                 self.coll_cfg)
            h_ind, self._ind_state = self._run(ind, self._ind_state,
                                               self.ind_cfg)
        self.metrics.inc("num_hits", len(h_coll) + len(h_ind))
        current = timestamp + CLOCKS_PER_TPC_TICK * T
        self._emit_tps(h_coll, self.collection_offlines, timestamp, current)
        self._emit_tps(h_ind, self.induction_offlines, timestamp, current)
        if self.tp_handler is not None:
            # drain every safely-closed window: one call emits at most one
            # aligned window (hpp:59-92 semantics); a batch spans several
            while self.tp_handler.try_sending_tpsets(current) is not None:
                pass

    def _run(self, adcs, state, cfg):
        """Run one plane's stream through the selected backend
        (reference | scan) with carried state."""
        from ..models import run_model
        return run_model(adcs, cfg, backend=self.backend, state=state,
                         device=self.device)

    def _ensure_stacks(self) -> None:
        """The planes' carried state as (KSTATE, C) tensors on the device."""
        if self._coll_stack is None:
            self._coll_stack = pack_state(self._coll_state,
                                          protowib.N_COLLECTION,
                                          device=self.device)
            self._ind_stack = pack_state(self._ind_state,
                                         protowib.N_INDUCTION,
                                         device=self.device)

    def _collect(self, c_slots, c_n, i_slots, i_n):
        """Both planes' slot buffers -> (collection hits, induction hits),
        counting the dropped closes."""
        h_coll, d_c = collect_hits(c_slots, c_n, protowib.N_COLLECTION,
                                   max_hits=self._max_hits,
                                   device=self._device_compact)
        h_ind, d_i = collect_hits(i_slots, i_n, protowib.N_INDUCTION,
                                  max_hits=self._max_hits,
                                  device=self._device_compact)
        if d_c or d_i:
            self.metrics.inc("num_hits_dropped", d_c + d_i)
        return h_coll, h_ind

    def _run_pallas_time2(self, flat_frames: np.ndarray):
        """Time2 host feed for one link: the host pays the 12-bit nibble
        decode + time pairing (native.relayout_time2_protowib, plane
        register order, unpadded rows), the device runs the time2 FIR
        datapath."""
        knobs = kernel_knobs(self.coll_cfg)
        self._ensure_stacks()
        T = flat_frames.shape[0]
        tc = auto_tc(T, cap=knobs["tc"])
        # the time2 datapath consumes two ticks per word: tc must be even
        # (T is even — 12 ticks per superchunk)
        if tc % 2:
            tc = next((d for d in range(tc, 1, -1)
                       if T % d == 0 and d % 2 == 0), T)

        def run(chan_idx, buf, stack, cfg):
            C = len(chan_idx)
            shape = native.time2_feed_shape(1, T, ch_per_link=C, pad8=False)
            feed = native.relayout_time2_protowib(
                flat_frames, chan_idx, out=buf.get(shape), pad8=False)
            return process_time2_feed(
                torch.from_numpy(feed).to(self.device), stack, cfg, C,
                tc=tc, k_slots=self.k_slots,
                fir_twopass=knobs["fir_twopass"])

        c_slots, c_n, self._coll_stack = run(
            protowib.COLLECTION_INDEX_TO_CHAN, self._t2_buf_coll,
            self._coll_stack, self.coll_cfg)
        i_slots, i_n, self._ind_stack = run(
            protowib.INDUCTION_INDEX_TO_CHAN, self._t2_buf_ind,
            self._ind_stack, self.ind_cfg)
        return self._collect(c_slots, c_n, i_slots, i_n)

    def _device_words(self, flat_frames: np.ndarray) -> torch.Tensor:
        """(T, 464) frames -> their (T, 116) words as int32 on the device
        (one host->device copy)."""
        return torch.from_numpy(protowib.frames_bytes_to_u32(flat_frames)
                                .view(np.int32)).to(self.device)

    def _run_pallas_packed(self, flat_frames: np.ndarray):
        """Packed device ingest for one link: the (T, 116) frame words
        shipped whole; one device decode, then both planes' launches."""
        knobs = kernel_knobs(self.coll_cfg)
        self._ensure_stacks()
        T = flat_frames.shape[0]
        tc = auto_tc(T, cap=knobs["tc"])
        (c_slots, c_n, self._coll_stack), (i_slots, i_n, self._ind_stack) = \
            process_packed_protowib(self._device_words(flat_frames),
                                    self._coll_stack, self._ind_stack,
                                    self.coll_cfg, self.ind_cfg, tc=tc,
                                    k_slots=self.k_slots,
                                    fir_twopass=knobs["fir_twopass"])
        return self._collect(c_slots, c_n, i_slots, i_n)

    def _emit_tps(self, hits: np.ndarray, offlines: np.ndarray,
                  timestamp: int, current_time: int) -> None:
        """add_hits_to_tphandler (hpp:586-676): WIB TP variant with
        clocksPerTPCTick = 25, peak = midpoint, adc_peak = charge/20."""
        # uint16 charge decode + zero-charge skip, like the reference
        # (WIBFrameProcessor.hpp:590, 628, 652-653)
        charge_u16 = hits["charge"].astype(np.int64) & 0xFFFF
        hits, charge_u16 = hits[charge_u16 != 0], charge_u16[charge_u16 != 0]
        if len(hits) == 0:
            return
        end_tick = hits["end_tick"].astype(np.int64)
        tover = hits["tover"].astype(np.int64)
        ts64 = ts_to_i64(timestamp)
        t_begin = ts64 + CLOCKS_PER_TPC_TICK * (end_tick - tover)
        t_end = ts64 + CLOCKS_PER_TPC_TICK * end_tick
        tps = np.zeros(len(hits), dtype=TP_DTYPE)
        tps["time_start"] = t_begin.astype(np.uint64)
        tps["time_peak"] = ((t_begin + t_end) // 2).astype(np.uint64)
        tps["time_over_threshold"] = (tover * CLOCKS_PER_TPC_TICK).astype(np.uint64)
        tps["channel"] = offlines[hits["channel"]]
        tps["adc_integral"] = charge_u16
        tps["adc_peak"] = charge_u16 // 20
        tps["detid"] = self.fiber_no
        tps["type"] = TPType.kTPC
        # the reference labels WIB FIR output kSimpleThreshold (hpp:659)
        tps["algorithm"] = TPAlgorithm.kSimpleThreshold
        tps["version"] = 1
        self.metrics.add_channel_tps(tps["channel"])
        if self.tp_handler is not None:
            accepted = self.tp_handler.add_tps(tps, current_time)
            self.metrics.inc("num_tps_sent", accepted)
            if accepted < len(tps):
                self.metrics.inc("num_tps_suppressed_too_long",
                                 len(tps) - accepted)
        else:
            self.metrics.inc("num_tps_sent", len(tps))
