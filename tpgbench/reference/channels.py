"""The HD APA channel map in the plain reference.

``PD2HD_APA_wibeth.txt`` beside this module lists one APA's channels, one
per line: ``offline crate slot stream stream_channel plane`` with plane
0 = U, 1 = V, 2 = collection (the DUNE offline convention).  Link l of an
APA is (slot l // 8, stream l % 8); offline numbers of crate k add
k * 2560 to the listed crate-0 numbers.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

MAP_FILE = Path(__file__).resolve().parent / "PD2HD_APA_wibeth.txt"
CHANNELS_PER_APA = 2560
COLLECTION = 2


def _table(path: Path = MAP_FILE) -> dict:
    rows = np.loadtxt(path, comments="#", dtype=np.int64, ndmin=2)
    return {(int(s), int(st), int(ch)): (int(off), int(pl))
            for off, _crate, s, st, ch, pl in rows}


def link_channels(n_links: int, crate: int, path: Path = MAP_FILE):
    """(offline (L * 64,) int64, collection (L * 64,) bool) of an APA's
    first ``n_links`` links in canonical order (link-major)."""
    table = _table(path)
    off = np.zeros(n_links * 64, dtype=np.int64)
    coll = np.zeros(n_links * 64, dtype=bool)
    for link in range(n_links):
        for ch in range(64):
            o, plane = table[(link // 8, link % 8, ch)]
            off[link * 64 + ch] = crate * CHANNELS_PER_APA + o
            coll[link * 64 + ch] = plane == COLLECTION
    return off, coll


def memory_factors(collection: np.ndarray, memory_factor_x10: int,
                   on_collection: bool) -> np.ndarray:
    """Per-channel RS memory factor (x10): 0 on collection channels when
    the threshold-on-collection setting is on, else the configured one."""
    mf = np.full(collection.shape, memory_factor_x10, dtype=np.int32)
    if on_collection:
        mf[collection] = 0
    return mf
