"""WIBEth frame processor — the flagship SWTPG pipeline.

Port copy of ``fdreadoutlibs_tpu/stream/wibeth.py``: the same code apart
from imports and the device seam.  It is carried here because importing
the original pulls in jax through its package's ``__init__``.  The
per-link SWTPG runs the port's kernel path: ``tpg_backend`` "pallas" or
"auto" (the default) is the hand-written CUDA kernel on ``device="cuda"``
(the default; no card raises) and its plain version on ``device="cpu"``;
"reference" is the numpy oracle and "scan" the port of the JAX package's
XLA scan (``ops/scan.py`` on ``device``, decoded by ``decode_dense``, as
the JAX processor's :417-426).  "auto" stays the kernel route: the JAX
package picks its scan only off the TPU.

Equivalent of WIBEthFrameProcessor + WIBEthFrameHandler
(src/wibeth/WIBEthFrameProcessor.cpp): preprocess = sequence_check +
timestamp_check (cpp:299-405), postprocess = find_hits -> SWTPG ->
process_swtpg_hits TP assembly (cpp:411-572) — vectorized over frame
batches, with the hot path on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..formats import wibeth
from ..formats.trigprim import TP_DTYPE, TPAlgorithm, TPType, ts_to_i64
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.config import Algorithm, TPGConfig
from ..ops.hits import decode_dense
from ..ops.ingest import collect_hits, process_packed_frames, \
    process_time2_feed
from ..ops.reference import process_window_reference
from ..ops.scan import process_window_scan, state_to_numpy, state_to_torch
from ..ops.tpg import auto_tc, pack_state, unpack_state
from ..utils.channel_map import make_map
from ..utils.tuning import kernel_knobs
from .errors import ErrorInterval
from .processor import TaskRawDataProcessor
from .transport import Sender

_ALGO_ENUM = {
    Algorithm.SIMPLE_THRESHOLD: TPAlgorithm.kSimpleThreshold,
    Algorithm.ABS_RS: TPAlgorithm.kAbsRunningSum,
    Algorithm.STANDARD_RS: TPAlgorithm.kRunningSum,
    # the legacy FIR family predates the algorithm enum (the wib/wib2 TP
    # assembly never set it; trgdataformats only names the wibeth three)
    Algorithm.FIR: TPAlgorithm.kUnknown,
}

CLOCKS_PER_TPC_TICK = wibeth.SAMPLES_TICK_DIFFERENCE  # 32


def assemble_tps(hits: np.ndarray, t_base, offline_table: np.ndarray,
                 det_id, tp_algo) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized hit->TP assembly (WIBEthFrameProcessor.cpp:479-572),
    shared by the per-link processor and the batched whole-APA path
    (apps/apa_readout.py — 40 per-link assembly calls per batch are
    per-call-overhead-bound, scripts/bench_tp_path.py).

    hits: HIT_DTYPE records.  t_base: per-hit base timestamp (scalar or
    (n,) int64 — the batched path passes the per-link batch timestamp
    gathered per hit).  offline_table: register->offline channel lookup
    indexed by hits["channel"].  det_id: scalar or per-hit vector.

    Semantics pinned here: a hit is recorded only when its uint16-decoded
    charge is nonzero (cpp:517-521 ``if (hit_charge[i] &&``); charge
    crosses as its uint16 reinterpretation (the reference decodes kernel
    output as uint16_t, cpp:484,544-545 — an RS hit whose samples sum
    negative yields a large adc_integral); t_begin = ts + 32*(end-tover),
    t_peak = t_begin + 32*peak_time (cpp:523-524).

    Returns (tps, kept): the TP array and the integer indices of the
    surviving hits (the caller's policy layer — channel mask, too-long
    suppression, metrics — may need per-hit provenance).
    """
    charge_u16 = hits["charge"].astype(np.int64) & 0xFFFF
    keep = charge_u16 != 0
    if not keep.all():
        kept = np.flatnonzero(keep)
        hits, charge_u16 = hits[kept], charge_u16[kept]
        if np.ndim(t_base):
            t_base = t_base[kept]
        if np.ndim(det_id):
            det_id = det_id[kept]
    else:
        kept = np.arange(len(hits))
    if len(hits) == 0:
        return np.zeros(0, dtype=TP_DTYPE), kept
    t_begin = (t_base + CLOCKS_PER_TPC_TICK
               * (hits["end_tick"].astype(np.int64)
                  - hits["tover"].astype(np.int64)))

    tps = np.zeros(len(hits), dtype=TP_DTYPE)
    tps["time_start"] = t_begin.astype(np.uint64)
    tps["time_peak"] = (t_begin + CLOCKS_PER_TPC_TICK *
                        hits["peak_time"].astype(np.int64)).astype(np.uint64)
    tps["time_over_threshold"] = (
        hits["tover"].astype(np.uint64) * CLOCKS_PER_TPC_TICK)
    tps["channel"] = offline_table[hits["channel"]]
    tps["adc_integral"] = charge_u16
    tps["adc_peak"] = hits["peak_adc"]
    tps["detid"] = det_id
    tps["type"] = TPType.kTPC
    tps["algorithm"] = tp_algo
    tps["version"] = 1
    return tps, kept


class WIBEthFrameProcessor(TaskRawDataProcessor):

    N_CHANNELS = wibeth.N_CHANNELS       # per link; subclasses override

    def __init__(self, error_registry=None, tp_sink: Optional[Sender] = None,
                 device="cuda"):
        super().__init__(error_registry)
        # the apps module imports this one, so resolve_device comes late
        from ..apps.apa_readout import resolve_device
        self.device = resolve_device(device)
        self.tp_sink = tp_sink
        self.tpg_enabled = False
        self.backend = "pallas"
        self._state = None
        self._first_hit = True
        self._dev_state = None
        self._state_stale = False

    # ------------------------------------------------------------------ conf
    def conf(self, config: dict) -> None:
        """Config keys mirror RawDataProcessorConf
        (WIBEthFrameProcessor.cpp:173-235)."""
        super().conf(config)
        self.source_id = config.get("source_id", 0)
        self.crate_no = config.get("crate_id", 0)
        self.slot_no = config.get("slot_id", 0)
        self.stream_id = config.get("link_id", 0)
        self.tp_max_width = config.get("tp_timeout", 10_000)
        self.channel_mask_set = set(config.get("tpg_channel_mask", []))
        self.enable_simple_threshold_on_collection = config.get(
            "enable_simple_threshold_on_collection", False)

        self.tpg_cfg = TPGConfig.from_raw(
            algorithm=config.get("tpg_algorithm", "SimpleThreshold"),
            threshold=config.get("tpg_threshold", 2000),
            rs_memory_factor=config.get("tpg_rs_memory_factor", 0.8),
            rs_scale_factor=config.get("tpg_rs_scale_factor", 2.0),
            frugal_streaming_accumulator_limit=config.get(
                "tpg_frugal_streaming_accumulator_limit", 10),
        )
        self.tp_algo = _ALGO_ENUM[self.tpg_cfg.algorithm]
        backend = config.get("tpg_backend", "auto")
        if backend not in ("auto", "pallas", "reference", "scan"):
            raise ValueError(f"unknown tpg_backend {backend!r}: expected "
                             "'auto' or 'pallas' (the kernel path on "
                             "self.device), 'scan' or 'reference'")
        self.backend = "pallas" if backend == "auto" else backend
        # per-chunk hit capacity: k per tc ticks (the JAX processor's
        # streaming default keeps headroom for pathological channels)
        self.k_slots = config.get("tpg_k_slots", 4)
        # compact the K-slot buffers to a hit list on the device (one small
        # device->host fetch); tpg_max_hits bounds it per batch (None ->
        # max(2048, 2x channels)), overflow counts as dropped
        self._device_compact = bool(config.get("tpg_device_compact", True))
        self._max_hits = config.get("tpg_max_hits")
        # time2 feed: the HOST unpacks the 14-bit codec and pairs two ticks
        # per int32 (native.relayout_time2, generic over ch_per_link); the
        # device runs the time2 datapath
        self._time2_feed = bool(config.get("tpg_time2_feed", False))
        self.error_counter_threshold = config.get("error_counter_threshold",
                                                  1000)
        self.add_preprocess_task(self.sequence_check)
        self.add_preprocess_task(self.timestamp_check)
        if config.get("enable_tpg", False):
            self.tpg_enabled = True
            self.channel_map = make_map(
                config.get("channel_map_name", "IdentityChannelMap"),
                **config.get("channel_map_args", {}))
            self.add_postprocess_task(self.find_hits)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = 0
        self.previous_seq_id = 0
        self._first_ts_check = True
        self._first_seq_check = True
        self._first_hit = True
        self._state = None
        self._dev_state = None
        self._state_stale = False
        self._t2_buf = native.FeedBuffer()    # time2 feed output reuse
        self.det_id = 0
        self._ts_problem_reported = False
        self._seq_problem_reported = False

    def _escalate(self, counter: str, flag: str, what: str) -> None:
        """Log-once 'Data Integrity ERROR' after the error-counter threshold
        (WIBEthFrameProcessor.cpp:344-350, 395-401)."""
        if (self.metrics.count(counter) > self.error_counter_threshold
                and not getattr(self, flag)):
            from ..utils.logging import log
            log.error("*** Data Integrity ERROR *** %s continuity is "
                      "completely broken! Something is wrong with the FE "
                      "source or with the configuration!", what)
            setattr(self, flag, True)

    # ------------------------------------------------ preprocess: seq check
    def sequence_check(self, frames: np.ndarray) -> None:
        """12-bit sequence-id continuity (WIBEthFrameProcessor.cpp:299-353),
        vectorized over the batch (including the batch boundary)."""
        n = frames.shape[0]
        if n == 0:
            return
        if self.emulator_mode:
            wibeth.fake_geoid(frames, self.crate_no, self.slot_no,
                              self.stream_id)
            wibeth.fake_seq_ids(frames, self.previous_seq_id + 1
                                if not self._first_seq_check else 0)
        seq = wibeth.get_header_field(frames, "seq_id").astype(np.int64)
        prev = np.concatenate([[self.previous_seq_id], seq[:-1]])
        expected = (prev + 1) & 0xFFF
        delta = (seq - expected).astype(np.int64)
        delta = np.where(delta > 0x800, delta - 0x1000, delta)
        delta = np.where(delta < -0x7FF, delta + 0x1000, delta)
        if self._first_seq_check:
            # no reference point for the very first payload
            delta[0] = 0
            self._first_seq_check = False
        bad = np.nonzero(delta != 0)[0]
        if len(bad):
            self.metrics.inc("num_seq_id_errors", len(bad))
            self.metrics.set_max("max_seq_id_jump", int(delta.max()))
            self.metrics.set_min("min_seq_id_jump", int(delta.min()))
            for i in bad[:16]:
                self.error_registry.add_error(
                    "SEQUENCE_ID_JUMP",
                    ErrorInterval(int(expected[i]), int(seq[i])))
            self._escalate("num_seq_id_errors", "_seq_problem_reported",
                           "Sequence ID")
        self.previous_seq_id = int(seq[-1])

    # ------------------------------------------ preprocess: timestamp check
    def timestamp_check(self, frames: np.ndarray) -> None:
        """Expected per-frame tick difference = 2048
        (WIBEthFrameProcessor.cpp:360-405)."""
        if frames.shape[0] == 0:
            return
        tick = wibeth.EXPECTED_TICK_DIFFERENCE
        if self.emulator_mode:
            first = (self.previous_ts + tick) if not self._first_ts_check else \
                wibeth.get_timestamp(frames)[0]
            wibeth.fake_timestamps(frames, first)
        ts = wibeth.get_timestamp(frames).astype(np.uint64)
        prev = np.concatenate([[np.uint64(self.previous_ts)], ts[:-1]])
        delta = ts - prev
        ok = delta == tick
        if self._first_ts_check:
            ok[0] = True
            self._first_ts_check = False
        bad = np.nonzero(~ok)[0]
        if len(bad):
            self.metrics.inc("num_ts_errors", len(bad))
            for i in bad[:16]:
                self.error_registry.add_error(
                    "MISSING_FRAMES",
                    ErrorInterval(int(prev[i]) + tick, int(ts[i])))
            self._escalate("num_ts_errors", "_ts_problem_reported",
                           "Timestamp")
        self.previous_ts = int(ts[-1])
        self.last_processed_daq_ts = int(ts[-1])

    # ------------------------------------------------- postprocess: SWTPG
    def _first_frame_setup(self, frames: np.ndarray, adcs0: np.ndarray):
        """First-payload bookkeeping (WIBEthFrameProcessor.cpp:426-464):
        link-misconfiguration check, channel map, per-channel RS memory
        factor (threshold-on-collection), state seeding."""
        crate = int(wibeth.get_header_field(frames, "crate_id")[0])
        slot = int(wibeth.get_header_field(frames, "slot_id")[0])
        stream = int(wibeth.get_header_field(frames, "stream_id")[0])
        self.det_id = int(wibeth.get_header_field(frames, "det_id")[0])
        if (crate, slot, stream) != (self.crate_no, self.slot_no,
                                     self.stream_id):
            self.metrics.inc("num_link_misconfigurations")
            self.error_registry.add_error(
                "LINK_MISCONFIGURATION", ErrorInterval(0, 0))

        C = wibeth.N_CHANNELS
        self.register_channels = self.channel_map.offline_channels(
            self.crate_no, self.slot_no, self.stream_id, C)
        planes = self.channel_map.planes(self.register_channels)
        if self.enable_simple_threshold_on_collection:
            # collection (plane 0) -> memoryless RS (cpp:441-450)
            self.register_memory_factor = np.where(
                planes == 0, 0, self.tpg_cfg.rs_memory_factor_x10)
        else:
            self.register_memory_factor = np.full(
                C, self.tpg_cfg.rs_memory_factor_x10)

        self.tpg_cfg.check_memory_factors(self.register_memory_factor)
        self._state = seed_chanstate(init_chanstate(C), adcs0,
                                     self.register_memory_factor)
        self._first_hit = False

    def find_hits(self, frames: np.ndarray) -> None:
        """Unpack + SWTPG over the batch (cpp:411-476).

        The kernel path ships only the packed ADC words to the device and
        unpacks them there — or, with tpg_time2_feed, the host codec's
        time2 feed."""
        if frames.shape[0] == 0:
            return
        timestamp = int(wibeth.get_timestamp(frames)[0])
        if self.backend == "pallas":
            words = wibeth.frames_bytes_to_u32(frames)
            if self._first_hit:
                first = wibeth.get_adcs(frames[:1]) \
                    .reshape(-1, wibeth.N_CHANNELS)[0].astype(np.int32)
                self._first_frame_setup(frames, first)
            if self._time2_feed:
                T = words.shape[0] * wibeth.N_TIME_SAMPLES
                hits = self._run_pallas_time2(words.reshape(1, T, -1))
            else:
                hits = self._run_pallas_packed(words)
        else:
            adcs = wibeth.get_adcs(frames).reshape(-1, wibeth.N_CHANNELS) \
                .astype(np.int32)
            if self._first_hit:
                self._first_frame_setup(frames, adcs[0])
            hits = self._run_backend(adcs)
        self.metrics.inc("num_hits", len(hits))
        self.process_swtpg_hits(hits, timestamp)

    def _run_kernel(self, ingest, feed: torch.Tensor, T: int,
                    even_tc: bool = False):
        """One batch through ``ingest`` (an ``ops.ingest`` entry) with the
        carried device state, then hit collection.  The state stays a
        (KSTATE, C) tensor on self.device between batches."""
        C = self.N_CHANNELS
        if self._dev_state is None:
            self._dev_state = pack_state(self._state, C, device=self.device)
        knobs = kernel_knobs(self.tpg_cfg)
        tc = auto_tc(T, cap=knobs["tc"])
        # the time2 datapath consumes two ticks per word: tc must be even
        # (T is even — 64 ticks/frame, 12/superchunk)
        if even_tc and tc % 2:
            tc = next((d for d in range(tc, 1, -1)
                       if T % d == 0 and d % 2 == 0), T)
        # the FIR schedule as the JAX processors pick it (wibeth.py:344,
        # 391; wib2.py:151): K5 when a tuned file names twopass 1 or 2
        slots, nclose, self._dev_state = ingest(
            feed, self._dev_state, self.tpg_cfg, C, tc=tc,
            k_slots=self.k_slots, fir_twopass=knobs["fir_twopass"])
        hits, dropped = collect_hits(slots, nclose, C,
                                     max_hits=self._max_hits,
                                     device=self._device_compact)
        if dropped:
            self.metrics.inc("num_hits_dropped", dropped)
        # the carried state lives on the device; current_state() unpacks
        # it on demand (no device->host sync per batch)
        self._state_stale = True
        return hits

    def _device_words(self, words: np.ndarray) -> torch.Tensor:
        """Packed uint32 words -> the same bits as an int32 tensor on
        self.device (one host->device copy)."""
        return torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(self.device)

    def _run_pallas_packed(self, words: np.ndarray):
        """Packed device ingest for one link: (N, 64, 28) packed words."""
        T = words.shape[0] * wibeth.N_TIME_SAMPLES
        return self._run_kernel(
            process_packed_frames,
            self._device_words(words.reshape(1, T, 28)), T)

    def _host_time2(self, words: np.ndarray) -> np.ndarray:
        """The time2 feed's host codec: (1, T, nw) packed words -> (T/2,
        ceil(C/128), 128) int32 (native.relayout_time2 with ch_per_link =
        N_CHANNELS — WIBEth nw=28, WIB2 nw=112 — and unpadded rows)."""
        C = self.N_CHANNELS
        L, T, _ = words.shape
        return native.relayout_time2(
            words, ch_per_link=C, pad8=False,
            out=self._t2_buf.get(native.time2_feed_shape(
                L, T, ch_per_link=C, pad8=False)))

    def _run_pallas_time2(self, words: np.ndarray):
        """Time2 host feed for one link: the host pays the 14-bit unpack +
        time pairing (:meth:`_host_time2`), the device runs the time2
        datapath."""
        feed = torch.from_numpy(self._host_time2(words)).to(self.device)
        return self._run_kernel(process_time2_feed, feed, words.shape[1],
                                even_tc=True)

    def current_state(self):
        """The live ChanState dict, materializing the device-resident state
        lazily (any inspection path must use this, not ._state, after
        kernel-path batches)."""
        if self._state_stale and self._dev_state is not None:
            self._state.update(unpack_state(self._dev_state))
            self._state_stale = False
        return self._state

    def _run_backend(self, adcs: np.ndarray):
        """The numpy oracle (tpg_backend="reference") or the scan on
        self.device ("scan")."""
        if self.backend == "reference":
            hits, self._state = process_window_reference(
                adcs, self._state, self.tpg_cfg)
            return hits
        closed, records, new_state = process_window_scan(
            torch.from_numpy(adcs).to(self.device),
            state_to_torch(self._state, self.device), self.tpg_cfg)
        self._state.update(state_to_numpy(new_state))
        return decode_dense(closed, records)

    # ------------------------------------------------------- TP assembly
    def process_swtpg_hits(self, hits: np.ndarray, timestamp: int) -> None:
        """Hit records -> TriggerPrimitives (cpp:479-572), vectorized.

        t_begin = ts + 32 * (end_tick - tover); t_peak = t_begin +
        32 * peak_time (cpp:523-524).
        """
        tps, _ = assemble_tps(hits, ts_to_i64(timestamp),
                              self.register_channels, self.det_id,
                              self.tp_algo)
        if len(tps) == 0:
            return
        self._filter_and_send(tps)

    def _filter_and_send(self, tps: np.ndarray) -> None:
        """Channel mask (cpp:528), too-long suppression (cpp:550-553),
        non-blocking send (cpp:555-558)."""
        if self.channel_mask_set:
            keep = ~np.isin(tps["channel"],
                            np.fromiter(self.channel_mask_set, dtype=np.int64))
            tps = tps[keep]
        too_long = tps["time_over_threshold"] > self.tp_max_width
        n_long = int(too_long.sum())
        if n_long:
            self.metrics.inc("num_tps_suppressed_too_long", n_long)
            tps = tps[~too_long]

        self.metrics.add_channel_tps(tps["channel"])
        if len(tps) == 0:
            return
        if self.tp_sink is not None:
            if not self.tp_sink.try_send(tps):
                self.metrics.inc("num_tps_send_failed", len(tps))
            else:
                self.metrics.inc("num_tps_sent", len(tps))
        else:
            self.metrics.inc("num_tps_sent", len(tps))
