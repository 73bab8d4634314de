"""DAPHNE photon-detector frame processors.

Port copy of ``fdreadoutlibs_tpu/stream/daphne.py:1-275``: the same code
apart from imports and the device seam.  The self-triggered processor is
numpy only.  The streaming processor takes a ``device``: under
``tpg_backend="pallas"`` ``_run_pallas_packed`` ships the packed words with
one host-to-device copy, unpacks them there and runs the kernel
(``ops.ingest.process_packed_daphne``, K2 on "cuda"; its plain version on
"cpu"), compacts the hits on the device (``ops.ingest.collect_hits``) and
keeps the carried state on the device, materialized by
:meth:`DAPHNEStreamFrameProcessor.current_state` on demand; "scan" runs
``models.run_model``'s scan (``ops/scan.py``) on the device and
"reference" the numpy oracle; "auto" (``RawDataProcessorConf``'s default)
means "pallas".  The TPU knobs ``tpg_pallas_interpret`` and unroll have no
counterpart.

Equivalents of DAPHNEFrameProcessor / DAPHNEStreamFrameProcessor
(src/daphne/*.cpp): preprocess timestamp bookkeeping only — the
self-triggered stream has no fixed arrival rate so the continuity check is
informational (cpp:54-59, emulator fakes +192 per superchunk with +16 per
frame, cpp:39-47); the streaming variant checks a fixed +64-per-frame
cadence.

The reference has NO PDS trigger-primitive generation; both processors here
optionally produce PDS TPs (``enable_tpg``) — a strict superset:

* streaming: the standard SWTPG core runs over the 4 continuous channels
  (1 clock tick per sample);
* self-triggered: each frame is an externally triggered 1024-sample
  waveform; vectorized pulse analysis (baseline from the leading samples,
  peak, integral and ToT above threshold) emits one TP per frame.
"""

from __future__ import annotations

import numpy as np

import torch

from ..formats import daphne
from ..formats.trigprim import TP_DTYPE, TPAlgorithm, TPType, ts_to_i64
from ..models import run_model
from ..ops import TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.ingest import collect_hits, process_packed_daphne
from ..ops.tpg import auto_tc, pack_state, unpack_state
from ..utils.tuning import kernel_knobs
from .errors import ErrorInterval
from .processor import TaskRawDataProcessor


class DAPHNEFrameProcessor(TaskRawDataProcessor):
    """Self-triggered PDS superchunks (12 x 1816 B)."""

    def __init__(self, error_registry=None, tp_sink=None):
        super().__init__(error_registry)
        self.tp_sink = tp_sink

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.add_preprocess_task(self.timestamp_check)
        self.tpg_threshold = config.get("tpg_threshold", 50)
        self.baseline_samples = config.get("tpg_baseline_samples", 64)
        self.det_id = config.get("det_id", 0)
        if config.get("enable_tpg", False):
            self.add_postprocess_task(self.find_pulses)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = 0
        self._first_ts_fake = True

    def find_pulses(self, superchunks: np.ndarray) -> None:
        """Vectorized pulse analysis over every triggered waveform:
        baseline = median of the leading samples; peak/integral/ToT above
        baseline + threshold.  One TP (type kPDS) per frame with a pulse."""
        frames = daphne.superchunk_frames(superchunks) \
            .reshape(-1, daphne.FRAME_SIZE)
        wfs = daphne.get_waveform(frames).astype(np.int32)   # (F, 1024)
        ts = daphne.get_timestamp(frames).astype(np.int64)
        channels = daphne.get_header_field(frames, "link_id")
        baseline = np.median(wfs[:, : self.baseline_samples], axis=1) \
            .astype(np.int32)
        sig = wfs - baseline[:, None]
        over = sig > self.tpg_threshold
        has_pulse = over.any(axis=1)
        if not has_pulse.any():
            return
        idx = np.nonzero(has_pulse)[0]
        sig_h = sig[idx]
        over_h = over[idx]
        peak_pos = np.argmax(sig_h, axis=1)
        tps = np.zeros(len(idx), dtype=TP_DTYPE)
        first_over = np.argmax(over_h, axis=1)
        tps["time_start"] = (ts[idx] + first_over).astype(np.uint64)
        tps["time_peak"] = (ts[idx] + peak_pos).astype(np.uint64)
        tps["time_over_threshold"] = over_h.sum(axis=1)
        tps["channel"] = channels[idx]
        tps["adc_integral"] = np.where(over_h, sig_h, 0).sum(axis=1)
        tps["adc_peak"] = sig_h[np.arange(len(idx)), peak_pos]
        tps["detid"] = self.det_id
        tps["type"] = TPType.kPDS
        tps["algorithm"] = TPAlgorithm.kSimpleThreshold
        tps["version"] = 1
        self.metrics.inc("num_hits", len(tps))
        self.metrics.add_channel_tps(tps["channel"])
        if self.tp_sink is not None and self.tp_sink.try_send(tps):
            self.metrics.inc("num_tps_sent", len(tps))

    def timestamp_check(self, superchunks: np.ndarray) -> None:
        """cpp:36-71: emulator fakes +192/superchunk (offset 16/frame);
        the rate check itself is disabled (self-triggered)."""
        n = superchunks.shape[0]
        if self.emulator_mode:
            for i in range(n):
                if self._first_ts_fake:
                    first = self.previous_ts
                    self._first_ts_fake = False
                else:
                    first = self.previous_ts + 192
                daphne.fake_timestamps(superchunks[i:i + 1], first, offset=16)
                self.previous_ts = first
        ts = daphne.get_first_timestamp(superchunks)
        self.previous_ts = int(np.asarray(ts).reshape(-1)[-1])
        self.last_processed_daq_ts = self.previous_ts
        self.metrics.inc("num_payloads", n)

    def frame_error_check(self, superchunks: np.ndarray) -> None:
        """cpp:76-81: header error-flag check (no flags defined yet)."""


class DAPHNEStreamFrameProcessor(TaskRawDataProcessor):
    """Streaming PDS superchunks (12 x 472 B, 4 ch x 64 samples each)."""

    def __init__(self, error_registry=None, tp_sink=None, device="cuda"):
        super().__init__(error_registry)
        # the apps module imports this one, so resolve_device comes late
        from ..apps.apa_readout import resolve_device
        self.device = resolve_device(device)
        self.tp_sink = tp_sink
        self._state = None
        self._pallas_stack = None
        self._state_stale = False

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.add_preprocess_task(self.timestamp_check)
        if config.get("enable_tpg", False):
            self.tpg_cfg = TPGConfig.from_raw(
                algorithm=config.get("tpg_algorithm", "SimpleThreshold"),
                threshold=config.get("tpg_threshold", 50))
            self.det_id = config.get("det_id", 0)
            self.backend = config.get("tpg_backend", "reference")
            if self.backend == "auto":      # the kernel route
                self.backend = "pallas"
            self.k_slots = config.get(
                "tpg_k_slots", config.get("tpg_pallas_k_slots", 4))
            self._device_compact = bool(
                config.get("tpg_device_compact", True))
            self._max_hits = config.get("tpg_max_hits")
            self.add_postprocess_task(self.find_hits)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = 0
        self._first_ts_check = True
        self._state = None
        self._pallas_stack = None
        self._state_stale = False

    def find_hits(self, superchunks: np.ndarray) -> None:
        """Standard SWTPG core over the 4 continuous channels — one clock
        tick per sample (superset of the reference, which has no PDS TPG).
        backend="pallas" takes the fused-ingest path: the packed 14-bit ADC
        region ships to the device and unpack+TPG run in one jit
        (ops/ingest.py:process_packed_daphne) on self.device."""
        flat = daphne.superchunk_frames(superchunks, stream=True) \
            .reshape(-1, daphne.STREAM_FRAME_SIZE)
        ts0 = int(daphne.stream_get_timestamp(flat[:1])[0])
        if self.backend == "pallas":
            hits = self._run_pallas_packed(flat)
        else:
            adcs = daphne.stream_get_adcs(flat) \
                .reshape(-1, daphne.STREAM_N_CHANNELS).astype(np.int32)
            if self._state is None:
                self._state = seed_chanstate(
                    init_chanstate(daphne.STREAM_N_CHANNELS), adcs[0],
                    self.tpg_cfg.rs_memory_factor_x10)
            hits, self._state = run_model(adcs, self.tpg_cfg,
                                          backend=self.backend,
                                          state=self._state,
                                          device=self.device)
        self.metrics.inc("num_hits", len(hits))
        if len(hits) == 0:
            return
        t_begin = ts_to_i64(ts0) + hits["end_tick"].astype(np.int64) \
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
        if self.tp_sink is not None and self.tp_sink.try_send(tps):
            self.metrics.inc("num_tps_sent", len(tps))

    def _run_pallas_packed(self, flat_frames: np.ndarray):
        """Packed device ingest for one PDS link: (N, 472 B) stream frames.
        The carried state stays a (KSTATE, 4) tensor on self.device."""
        C = daphne.STREAM_N_CHANNELS
        N = flat_frames.shape[0]
        T = N * daphne.STREAM_N_SAMPLES
        knobs = kernel_knobs(self.tpg_cfg)
        if self._pallas_stack is None:
            # a checkpoint-restored ._state resumes exactly; otherwise
            # seed from this batch's first sample (setState semantics)
            state = self._state
            if state is None:
                first = daphne.stream_get_adcs(flat_frames[:1])[0, 0] \
                    .astype(np.int32)
                state = seed_chanstate(init_chanstate(C), first,
                                       self.tpg_cfg.rs_memory_factor_x10)
            self._pallas_stack = pack_state(state, C, device=self.device)
        words = daphne.stream_frames_bytes_to_u32(flat_frames)[None]
        slots, nclose, self._pallas_stack = process_packed_daphne(
            torch.from_numpy(words.view(np.int32)).to(self.device),
            self._pallas_stack, self.tpg_cfg, C,
            tc=auto_tc(T, cap=knobs["tc"]), k_slots=self.k_slots,
            fir_twopass=knobs["fir_twopass"], geometry=knobs["geometry"])
        hits, dropped = collect_hits(slots, nclose, C,
                                     max_hits=self._max_hits,
                                     device=self._device_compact)
        if dropped:
            self.metrics.inc("num_hits_dropped", dropped)
        # ._state is now stale; materialized lazily by current_state()
        self._state_stale = True
        return hits

    def current_state(self):
        """Live ChanState for checkpointing: the pallas path carries state
        only in the device stack, so materialize it on demand (the scan/
        reference backends keep ._state fresh already).  Gated on
        staleness like the wibeth processor: repeated checkpoints without
        an intervening batch must not re-pay the device->host sync."""
        if self._state_stale and self._pallas_stack is not None:
            st = unpack_state(self._pallas_stack)
            if self._state is None:
                self._state = st
            else:
                self._state.update(st)
            self._state_stale = False
        return self._state

    def timestamp_check(self, superchunks: np.ndarray) -> None:
        """DAPHNEStreamFrameProcessor.cpp:39-49: fixed +64/frame cadence."""
        if superchunks.shape[0] == 0:
            return
        tick = daphne.STREAM_EXPECTED_TICK_DIFFERENCE
        per_chunk = tick * daphne.STREAM_FRAMES_PER_SUPERCHUNK
        if self.emulator_mode:
            first = (self.previous_ts + per_chunk) if not self._first_ts_check \
                else int(np.asarray(
                    daphne.get_first_timestamp(superchunks, stream=True)
                ).reshape(-1)[0])
            for i in range(superchunks.shape[0]):
                daphne.fake_timestamps(superchunks[i:i + 1],
                                       first + i * per_chunk,
                                       offset=tick, stream=True)
        ts = np.asarray(daphne.get_first_timestamp(superchunks, stream=True),
                        dtype=np.uint64).reshape(-1)
        prev = np.concatenate([[np.uint64(self.previous_ts)], ts[:-1]])
        ok = (ts - prev) == per_chunk
        if self._first_ts_check:
            ok[0] = True
            self._first_ts_check = False
        bad = np.nonzero(~ok)[0]
        if len(bad):
            self.metrics.inc("num_ts_errors", len(bad))
            for i in bad[:16]:
                self.error_registry.add_error(
                    "MISSING_FRAMES",
                    ErrorInterval(int(prev[i]) + per_chunk, int(ts[i])))
        self.previous_ts = int(ts[-1])
        self.last_processed_daq_ts = int(ts[-1])
