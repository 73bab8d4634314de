"""WIB2 frame processor.

Port copy of ``fdreadoutlibs_tpu/stream/wib2.py`` on the port's WIBEth
processor: the same code apart from imports and the device seam
(``_run_pallas_packed_wib2`` runs the port's ``ops.ingest``).

Equivalent of WIB2FrameProcessor + WIB2FrameHandler
(src/wib2/WIB2FrameProcessor.cpp): preprocess = superchunk timestamp check
(delta = 32 * 12, cpp:289-340, including the first-frame crate/slot/link
vs configuration check); postprocess = SWTPG over all 256 channels.

The reference splits the 256 channels into two register-selector halves
processed as two tasks (cpp:224-225) because one AVX2 pass covers 128
channels; here the whole 256-channel frame is one kernel launch.

TP assembly follows the WIB2 variant (cpp:420-460): time_peak =
(t_begin + t_end) / 2 and adc_peak = adc_integral / 20 — the wib2 kernels
predate the peak-tracking registers.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.config import Algorithm

from ..formats import wib2
from ..formats.trigprim import TP_DTYPE, TPType, ts_to_i64
from ..ops.ingest import process_packed_wib2
from .errors import ErrorInterval
from .wibeth import WIBEthFrameProcessor

CLOCKS_PER_TPC_TICK = 32


class WIB2FrameProcessor(WIBEthFrameProcessor):
    """Reuses the WIBEth pipeline/backends with WIB2 geometry and TP math."""

    N_CHANNELS = wib2.N_CHANNELS

    def conf(self, config: dict) -> None:
        super().conf(config)
        # WIB2 has no per-frame sequence counter; drop the seq check task
        self._preprocess = [t for t in self._preprocess
                            if t != self.sequence_check]
        # WIB2 TP assembly derives peaks ((begin+end)/2, charge/20) like
        # the reference FIR kernels, which carry no peak registers —
        # drop peak tracking from the hot loop
        if self.tpg_cfg.algorithm == Algorithm.FIR and \
                config.get("tpg_track_peaks") is None:
            self.tpg_cfg = replace(self.tpg_cfg, track_peaks=False)

    # ---------------------------------------------------------- preprocess
    def timestamp_check(self, superchunks: np.ndarray) -> None:
        """Superchunk-level timestamp continuity (cpp:289-340)."""
        if superchunks.shape[0] == 0:
            return
        tick = wib2.SUPERCHUNK_TICK_DIFFERENCE
        frames = wib2.superchunk_frames(superchunks)
        if self.emulator_mode:
            first = (self.previous_ts + tick) if not self._first_ts_check else \
                int(wib2.get_timestamp(frames[0, :1])[0])
            wib2.fake_timestamps(superchunks, first)
            wib2.fake_geoid(superchunks, self.crate_no, self.slot_no,
                            self.stream_id)
        ts = wib2.get_timestamp(frames[:, 0]).astype(np.uint64)
        if self._first_ts_check:
            # first-frame geo-id check (cpp:314-319)
            crate = int(wib2.get_header_field(frames[:1, 0], "crate")[0])
            slot = int(wib2.get_header_field(frames[:1, 0], "slot")[0])
            link = int(wib2.get_header_field(frames[:1, 0], "link")[0])
            if (crate, slot, link) != (self.crate_no, self.slot_no,
                                       self.stream_id):
                self.metrics.inc("num_link_misconfigurations")
                self.error_registry.add_error("LINK_MISCONFIGURATION",
                                              ErrorInterval(0, 0))
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

    # --------------------------------------------------------- postprocess
    def _first_frame_setup(self, superchunks: np.ndarray, adcs0: np.ndarray):
        frames0 = wib2.superchunk_frames(superchunks)[:1, 0]
        self.det_id = int(wib2.get_header_field(frames0, "detector_id")[0])
        C = self.N_CHANNELS
        self.register_channels = self.channel_map.offline_channels(
            self.crate_no, self.slot_no, self.stream_id, C)
        planes = self.channel_map.planes(self.register_channels)
        if self.enable_simple_threshold_on_collection:
            self.register_memory_factor = np.where(
                planes == 0, 0, self.tpg_cfg.rs_memory_factor_x10)
        else:
            self.register_memory_factor = np.full(
                C, self.tpg_cfg.rs_memory_factor_x10)
        self._state = seed_chanstate(init_chanstate(C), adcs0,
                                     self.register_memory_factor)
        self._first_hit = False

    def find_hits(self, superchunks: np.ndarray) -> None:
        if superchunks.shape[0] == 0:
            return
        frames = wib2.superchunk_frames(superchunks)
        timestamp = int(wib2.get_timestamp(frames[0, :1])[0])
        if self._first_hit:
            first = wib2.get_adcs(frames[:1, 0]).reshape(-1).astype(np.int32)
            self._first_frame_setup(superchunks, first)
        if self.backend == "pallas":
            hits = self._run_pallas_packed_wib2(frames)
        else:
            # (N, 12, 256): each frame is ONE tick of 256 channels
            adcs = wib2.get_adcs(frames).reshape(-1, self.N_CHANNELS) \
                .astype(np.int32)
            hits = self._run_backend(adcs)
        self.metrics.inc("num_hits", len(hits))
        self.process_swtpg_hits(hits, timestamp)

    def _run_pallas_packed_wib2(self, frames: np.ndarray):
        """Packed device ingest: 112-word rows unpacked on the device — or,
        with tpg_time2_feed, the host-codec time2 path (the inherited
        _run_pallas_time2 is generic over ch_per_link)."""
        words = np.ascontiguousarray(wib2.adc_region_u32(frames)) \
            .reshape(1, -1, wib2.ADC_WORDS)
        if self._time2_feed:
            return self._run_pallas_time2(words)
        return self._run_kernel(process_packed_wib2,
                                self._device_words(words), words.shape[1])

    # ------------------------------------------------------- TP assembly
    def process_swtpg_hits(self, hits: np.ndarray, timestamp: int) -> None:
        """WIB2 TP variant (cpp:420-460)."""
        # zero-uint16-charge hits are skipped and charge crosses as its
        # uint16 reinterpretation, like the reference decode (cpp:404,
        # 429, 453-454 — adc_peak divides the UNSIGNED value)
        charge_u16 = hits["charge"].astype(np.int64) & 0xFFFF
        hits, charge_u16 = hits[charge_u16 != 0], charge_u16[charge_u16 != 0]
        if len(hits) == 0:
            return
        end_tick = hits["end_tick"].astype(np.int64)
        tover = hits["tover"].astype(np.int64)
        ts64 = ts_to_i64(timestamp)
        t_begin = ts64 + CLOCKS_PER_TPC_TICK * (end_tick - tover)
        t_end = ts64 + CLOCKS_PER_TPC_TICK * end_tick
        offline = self.register_channels[hits["channel"]]

        tps = np.zeros(len(hits), dtype=TP_DTYPE)
        tps["time_start"] = t_begin.astype(np.uint64)
        tps["time_peak"] = ((t_begin + t_end) // 2).astype(np.uint64)
        tps["time_over_threshold"] = (tover * CLOCKS_PER_TPC_TICK).astype(np.uint64)
        tps["channel"] = offline
        tps["adc_integral"] = charge_u16
        tps["adc_peak"] = charge_u16 // 20
        tps["detid"] = self.det_id
        tps["type"] = TPType.kTPC
        tps["algorithm"] = self.tp_algo
        tps["version"] = 1
        self._filter_and_send(tps)
