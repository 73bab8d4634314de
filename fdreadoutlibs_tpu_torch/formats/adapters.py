"""Type-adapter registry — port copy of ``fdreadoutlibs_tpu/formats/adapters.py``
with the WIBEth adapter only (the one the APA app retains raw frames
with).  The other formats are not ported yet.

The reference's adapters (include/fdreadoutlibs/*TypeAdapter.hpp) are POD
wrappers exposing fixed sizes, tick differences and fake_* helpers to the
generic readout templates.  Here each adapter is a descriptor pointing at
its format module's vectorized accessors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import wibeth


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
}


def get_adapter(name: str) -> TypeAdapter:
    return ADAPTERS[name]
