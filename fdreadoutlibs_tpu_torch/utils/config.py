"""Configuration schema.

Port copy of ``fdreadoutlibs_tpu/utils/config.py:1-91``; the code is
unchanged.  The port's processors read these keys with ``config.get`` and
accept ``RawDataProcessorConf().as_dict()``; ``tpg_backend`` "auto" means
the kernel route on the processor's device ("pallas"), "scan" the port's
``ops/scan.py``, and ``tpg_pallas_interpret`` (a TPU knob) is read by no
processor of the port.

Mirrors the reference's codegen'd config structs (SURVEY.md §5):
``RawDataProcessorConf`` (WIBEthFrameProcessor.cpp:175-224) and
``ReadoutModelConf`` (TPCTPRequestHandler.cpp:20-27), as dataclasses with
JSON round-trip.  The processors/handlers consume plain dicts (nlohmann
style); these classes validate and document the key set.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path


@dataclass
class RawDataProcessorConf:
    """Per-link processor configuration (observed keys, SURVEY.md §5)."""
    source_id: int = 0
    emulator_mode: bool = False
    enable_tpg: bool = False
    tpg_algorithm: str = "SimpleThreshold"
    tpg_threshold: int = 2000
    tpg_channel_mask: list = field(default_factory=list)
    tpg_rs_memory_factor: float = 0.8
    tpg_rs_scale_factor: float = 2.0
    tpg_frugal_streaming_accumulator_limit: int = 10
    enable_simple_threshold_on_collection: bool = False
    channel_map_name: str = "IdentityChannelMap"
    crate_id: int = 0
    slot_id: int = 0
    link_id: int = 0
    tp_timeout: int = 100_000           # max TP width in ticks
    clock_speed_hz: int = 62_500_000
    error_counter_threshold: int = 100
    error_reset_freq: int = 10_000
    # TPU-framework extensions
    tpg_backend: str = "auto"           # auto | reference | scan | pallas
    tpg_k_slots: int = 4                # per-chunk hit capacity
    tpg_pallas_interpret: bool = False
    tpg_device_compact: bool = True     # compact hit list on device
    tpg_max_hits: int | None = None     # None -> max(2048, 2x channels)
    tpg_track_peaks: bool | None = None  # None -> algorithm default
    channel_map_args: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class ReadoutModelConf:
    """TPSet-sender configuration (TPCTPRequestHandler.cpp:20-27)."""
    source_id: int = 0
    tpset_sourceid: int = 0
    tpset_transmission_rate_hz: int = 200
    tpset_min_latency_ticks: int = 100_000
    tardy_tp_quiet_time_at_start_sec: int = 10
    tpset_window_size: int = 100_000
    # TPU-framework extension: quiet links keep emitting kHeartbeat TPSets
    # driven by observed stream time (tp/request_handler.py)
    emit_heartbeats_when_empty: bool = True

    def as_dict(self) -> dict:
        return asdict(self)


def _from_dict(cls, blob: dict):
    names = {f.name for f in fields(cls)}
    known = {k: v for k, v in blob.items() if k in names}
    unknown = set(blob) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**known)


def load_config(path_or_dict):
    """Load a full module configuration:
    {"rawdataprocessorconf": {...}, "readoutmodelconf": {...}}
    (the nlohmann blob shape the reference's conf() receives)."""
    blob = path_or_dict
    if not isinstance(blob, dict):
        blob = json.loads(Path(path_or_dict).read_text())
    out = {}
    if "rawdataprocessorconf" in blob:
        out["rawdataprocessorconf"] = _from_dict(
            RawDataProcessorConf, blob["rawdataprocessorconf"])
    if "readoutmodelconf" in blob:
        out["readoutmodelconf"] = _from_dict(
            ReadoutModelConf, blob["readoutmodelconf"])
    return out
