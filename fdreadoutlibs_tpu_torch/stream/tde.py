"""TDE (vertical-drift top-electronics) frame processor.

Port copy of ``fdreadoutlibs_tpu/stream/tde.py:1-165``: the same code apart
from imports and the device: ``run_model`` runs on the processor's
``device`` ("cuda" launches the kernel under "pallas" and raises without a
card; "cpu" runs the plain version), and the numpy oracle under
"reference".

Equivalent of TDEFrameProcessor (src/tde/TDEFrameProcessor.cpp): a TDE link
interleaves 64 per-channel frames, so timestamp continuity is tracked with
a *per-channel* previous-timestamp array (hpp:62, cpp:34-77); the first
frame of each channel establishes its baseline.

Beyond the reference (which has no TDE TPG): with ``enable_tpg`` the
standard SWTPG core runs over complete channel cycles — a batch carrying
one frame per channel reshapes into a (samples, 64) stream and flows
through the same pipeline as the horizontal-drift frontends, with per-
channel streaming state carried across batches.
"""

from __future__ import annotations

import numpy as np

from ..formats import tde
from ..formats.trigprim import TP_DTYPE, TPAlgorithm, TPType, ts_to_i64
from ..models import run_model
from ..ops import TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..utils.channel_map import make_map
from .errors import ErrorInterval
from .processor import TaskRawDataProcessor


class TDEFrameProcessor(TaskRawDataProcessor):

    def __init__(self, error_registry=None, tp_sink=None, device="cuda"):
        super().__init__(error_registry)
        # the apps module imports this one, so resolve_device comes late
        from ..apps.apa_readout import resolve_device
        self.device = resolve_device(device)
        self.tp_sink = tp_sink

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.add_preprocess_task(self.timestamp_check)
        self.add_preprocess_task(self.frame_error_check)
        if config.get("enable_tpg", False):
            self.tpg_cfg = TPGConfig.from_raw(
                algorithm=config.get("tpg_algorithm", "SimpleThreshold"),
                threshold=config.get("tpg_threshold", 500))
            self.det_id = config.get("det_id", 0)
            self.backend = config.get("tpg_backend", "reference")
            # vertical-drift channel map: TPs carry offline channels when a
            # map is configured (channel_map_name, like the HD processors);
            # crate/slot locate this link in the VD geometry
            self._offline = None
            map_name = config.get("channel_map_name")
            if map_name:
                ch_map = make_map(map_name,
                                  **config.get("channel_map_args", {}))
                self._offline = ch_map.offline_channels(
                    config.get("crate_id", 0), config.get("slot_id", 0),
                    config.get("link_id", 0), tde.N_CHANNELS_PER_LINK)
            self.add_postprocess_task(self.find_hits)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = np.zeros(tde.N_CHANNELS_PER_LINK, dtype=np.uint64)
        self._state = None
        self._state_channels = None

    def find_hits(self, frames: np.ndarray) -> None:
        """SWTPG over complete channel cycles.  The batch must contain an
        equal number of frames per channel (the link's natural cadence —
        cf. test/apps/tde_file_creator.cxx writing 64-channel batches);
        frames are ordered by (timestamp, channel) first."""
        if frames.shape[0] == 0:
            return
        order = tde.sort_key(frames)
        frames = frames[order]
        channels = tde.get_channel(frames)
        counts = np.bincount(channels, minlength=64)
        active = np.nonzero(counts)[0]
        if len(active) == 0 or not (counts[active] == counts[active[0]]).all():
            self.metrics.inc("num_incomplete_tpg_batches")
            return
        n_cycles = int(counts[active[0]])
        C = len(active)
        S = tde.TOT_ADC16_SAMPLES
        ts0 = int(tde.get_timestamp(frames[:1])[0])
        # (cycles, C, S) -> (cycles*S, C); samples are TICKS_BETWEEN apart
        adcs = tde.get_adc_samples(frames).reshape(n_cycles, C, S) \
            .transpose(0, 2, 1).reshape(n_cycles * S, C).astype(np.int32)
        if self._state is None or \
                not np.array_equal(active, self._state_channels):
            # the active-channel set changed mid-stream (dropped/duplicated
            # frames upstream): re-seed new channels, carry the streaming
            # state of persisting ones — the scan carry is shaped (C,) and
            # must match the batch width (found by scripts/fuzz_frames.py)
            new_state = seed_chanstate(init_chanstate(C), adcs[0],
                                       self.tpg_cfg.rs_memory_factor_x10)
            if self._state is not None:
                self.metrics.inc("num_tpg_channel_set_changes")
                prev_idx = {int(c): i for i, c
                            in enumerate(self._state_channels)}
                pairs = [(j, prev_idx[int(c)]) for j, c in enumerate(active)
                         if int(c) in prev_idx]
                if pairs:
                    dst, src = (np.array(p) for p in zip(*pairs))
                    for k, v in self._state.items():
                        arr, new = np.asarray(v), np.asarray(new_state[k])
                        if arr.ndim == 0:      # fir_phase: stream-global
                            new_state[k] = v
                        elif arr.ndim == 2:    # fir_prev: (taps, C)
                            new[:, dst] = arr[:, src]
                            new_state[k] = new
                        else:
                            new[dst] = arr[src]
                            new_state[k] = new
            self._state = new_state
            self._state_channels = active.copy()
        hits, self._state = run_model(adcs, self.tpg_cfg,
                                      backend=self.backend,
                                      state=self._state, device=self.device)
        self.metrics.inc("num_hits", len(hits))
        if len(hits) == 0:
            return
        clocks = tde.TICKS_BETWEEN_ADC_SAMPLES
        t_begin = ts_to_i64(ts0) + clocks * (
            hits["end_tick"].astype(np.int64) - hits["tover"].astype(np.int64))
        tps = np.zeros(len(hits), dtype=TP_DTYPE)
        tps["time_start"] = t_begin.astype(np.uint64)
        tps["time_peak"] = (t_begin + clocks *
                            hits["peak_time"].astype(np.int64)).astype(np.uint64)
        tps["time_over_threshold"] = hits["tover"].astype(np.uint64) * clocks
        link_ch = active[hits["channel"]]
        tps["channel"] = link_ch if self._offline is None \
            else self._offline[link_ch]
        tps["adc_integral"] = hits["charge"]
        tps["adc_peak"] = hits["peak_adc"]
        tps["detid"] = self.det_id
        tps["type"] = TPType.kTPC
        tps["algorithm"] = TPAlgorithm.kSimpleThreshold
        tps["version"] = 1
        self.metrics.add_channel_tps(tps["channel"])
        if self.tp_sink is not None and self.tp_sink.try_send(tps):
            self.metrics.inc("num_tps_sent", len(tps))

    def timestamp_check(self, frames: np.ndarray) -> None:
        tick = tde.EXPECTED_TICK_DIFFERENCE
        channels = tde.get_channel(frames)
        if self.emulator_mode:
            # cpp:40-46: each channel's ts = its previous + tick
            for i, ch in enumerate(channels):
                prev = self.previous_ts[ch]
                if prev == 0:
                    prev = tde.get_timestamp(frames[i:i + 1])[0]
                    self.previous_ts[ch] = prev
                else:
                    tde.set_timestamp(frames[i:i + 1], prev + tick)
        ts = tde.get_timestamp(frames)
        for i, ch in enumerate(channels):
            prev = self.previous_ts[ch]
            if prev != 0 and (int(ts[i]) - int(prev)) % (1 << 64) != tick:
                self.metrics.inc("num_ts_errors")
                self.error_registry.add_error(
                    "MISSING_FRAMES", ErrorInterval(int(prev) + tick, int(ts[i])))
            self.previous_ts[ch] = ts[i]
        if len(ts):
            self.last_processed_daq_ts = int(ts[-1])

    def frame_error_check(self, frames: np.ndarray) -> None:
        """cpp: header error-flag check (placeholder in the reference too)."""
