"""Type-adapter registry: the duck-typed traits every payload type exposes.

Port copy of ``fdreadoutlibs_tpu/formats/adapters.py:1-137``, every entry
of ``ADAPTERS``: the same code apart from imports. It is carried here
because importing the original pulls in jax through its package's
``__init__``.

The reference's adapters (include/fdreadoutlibs/*TypeAdapter.hpp) are POD
wrappers exposing fixed sizes, tick differences and fake_* helpers to the
generic readout templates.  Here each adapter is a descriptor pointing at
its format module's vectorized accessors — the registry is what the
latency-buffer / source-emulator / processor layers key on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import daphne, protowib, ssp, tde, trigprim, wib2, wibeth


@dataclass(frozen=True)
class TypeAdapter:
    name: str
    fixed_payload_size: int           # bytes per payload
    fragment_type: str
    subsystem: str
    expected_tick_difference: int     # per frame
    payload_tick_difference: int      # per payload (superchunk)
    num_frames: int
    get_first_timestamp: Callable
    set_first_timestamp: Callable
    fake_timestamps: Optional[Callable] = None

    def empty(self, n: int = 1) -> np.ndarray:
        return np.zeros((n, self.fixed_payload_size), dtype=np.uint8)


def _first_frame(payload_bytes: np.ndarray, frame_size: int) -> np.ndarray:
    return payload_bytes[..., :frame_size]


ADAPTERS = {
    # DUNEWIBEthTypeAdapter.hpp: 1 frame per payload
    "wibeth": TypeAdapter(
        name="wibeth", fixed_payload_size=wibeth.FRAME_SIZE,
        fragment_type="kWIBEth", subsystem="kDetectorReadout",
        expected_tick_difference=wibeth.EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=wibeth.EXPECTED_TICK_DIFFERENCE,
        num_frames=1,
        get_first_timestamp=wibeth.get_timestamp,
        set_first_timestamp=wibeth.set_timestamp,
        fake_timestamps=wibeth.fake_timestamps,
    ),
    # DUNEWIBSuperChunkTypeAdapter.hpp: 12 x 472 B
    "wib2": TypeAdapter(
        name="wib2", fixed_payload_size=wib2.SUPERCHUNK_SIZE,
        fragment_type="kWIB", subsystem="kDetectorReadout",
        expected_tick_difference=wib2.EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=wib2.SUPERCHUNK_TICK_DIFFERENCE,
        num_frames=wib2.FRAMES_PER_SUPERCHUNK,
        get_first_timestamp=lambda p: wib2.get_timestamp(
            _first_frame(p, wib2.FRAME_SIZE)),
        set_first_timestamp=lambda p, ts: wib2.set_timestamp(
            _first_frame(p, wib2.FRAME_SIZE), ts),
        fake_timestamps=wib2.fake_timestamps,
    ),
    # ProtoWIBSuperChunkTypeAdapter.hpp: 12 x 464 B FELIX superchunk
    "protowib": TypeAdapter(
        name="protowib", fixed_payload_size=protowib.SUPERCHUNK_SIZE,
        fragment_type="kProtoWIB", subsystem="kDetectorReadout",
        expected_tick_difference=protowib.EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=protowib.SUPERCHUNK_TICK_DIFFERENCE,
        num_frames=protowib.FRAMES_PER_SUPERCHUNK,
        get_first_timestamp=lambda p: protowib.get_timestamp(
            _first_frame(p, protowib.FRAME_SIZE)),
        set_first_timestamp=lambda p, ts: protowib.set_timestamp(
            _first_frame(p, protowib.FRAME_SIZE), ts),
        fake_timestamps=protowib.fake_timestamps,
    ),
    # DAPHNESuperChunkTypeAdapter.hpp: 12 x 1816 B
    "daphne": TypeAdapter(
        name="daphne", fixed_payload_size=daphne.SUPERCHUNK_SIZE,
        fragment_type="kDAPHNE", subsystem="kDetectorReadout",
        expected_tick_difference=daphne.EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=192,      # emulator spacing (cpp:39-47)
        num_frames=daphne.FRAMES_PER_SUPERCHUNK,
        get_first_timestamp=lambda p: daphne.get_first_timestamp(p),
        set_first_timestamp=lambda p, ts: daphne.set_timestamp(
            daphne.superchunk_frames(p)[..., 0, :], ts),
        fake_timestamps=daphne.fake_timestamps,
    ),
    # DAPHNEStreamSuperChunkTypeAdapter.hpp: 12 x 472 B
    "daphne_stream": TypeAdapter(
        name="daphne_stream", fixed_payload_size=daphne.STREAM_SUPERCHUNK_SIZE,
        fragment_type="kDAPHNEStream", subsystem="kDetectorReadout",
        expected_tick_difference=daphne.STREAM_EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=daphne.STREAM_EXPECTED_TICK_DIFFERENCE
        * daphne.STREAM_FRAMES_PER_SUPERCHUNK,
        num_frames=daphne.STREAM_FRAMES_PER_SUPERCHUNK,
        get_first_timestamp=lambda p: daphne.get_first_timestamp(p, stream=True),
        set_first_timestamp=lambda p, ts: daphne.stream_set_timestamp(
            daphne.superchunk_frames(p, stream=True)[..., 0, :], ts),
        fake_timestamps=lambda p, ts, offset=64: daphne.fake_timestamps(
            p, ts, offset, stream=True),
    ),
    # TDEFrameTypeAdapter.hpp: 1 frame; orders by (timestamp, channel)
    "tde": TypeAdapter(
        name="tde", fixed_payload_size=tde.FRAME_SIZE,
        fragment_type="kTDE_AMC", subsystem="kDetectorReadout",
        expected_tick_difference=tde.EXPECTED_TICK_DIFFERENCE,
        payload_tick_difference=tde.EXPECTED_TICK_DIFFERENCE,
        num_frames=1,
        get_first_timestamp=tde.get_timestamp,
        set_first_timestamp=tde.set_timestamp,
        fake_timestamps=tde.fake_timestamps,
    ),
    # SSPFrameTypeAdapter.hpp
    "ssp": TypeAdapter(
        name="ssp", fixed_payload_size=ssp.FRAME_SIZE,
        fragment_type="kPDSData", subsystem="kDetectorReadout",
        expected_tick_difference=1, payload_tick_difference=1, num_frames=1,
        get_first_timestamp=ssp.get_timestamp,
        set_first_timestamp=ssp.set_timestamp,
    ),
    # TriggerPrimitiveTypeAdapter.hpp: TPs themselves as payloads
    "trigger_primitive": TypeAdapter(
        name="trigger_primitive",
        fixed_payload_size=trigprim.TP_DTYPE.itemsize,
        fragment_type="kTriggerPrimitive", subsystem="kTrigger",
        expected_tick_difference=1, payload_tick_difference=1, num_frames=1,
        get_first_timestamp=lambda tps: tps["time_start"],
        set_first_timestamp=lambda tps, ts: tps.__setitem__("time_start", ts),
    ),
}


def get_adapter(name: str) -> TypeAdapter:
    return ADAPTERS[name]
