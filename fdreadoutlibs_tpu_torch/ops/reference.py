"""Numpy golden oracle for the SWTPG pipeline.

Copied from ``fdreadoutlibs_tpu/ops/reference.py:1-62``; the code is
unchanged and runs the port's copy of ``ops/step.py``.

Equivalent of the reference's naive kernels (ProcessNaive.hpp:40-141,
ProcessNaiveRS.hpp:22-179) — vectorized over channels, explicit Python loop
over time, exact int16 fixed-point semantics.
"""

from __future__ import annotations

import numpy as np

from .chanstate import ChanState, init_chanstate, seed_chanstate
from .config import TPGConfig
from .hits import HIT_DTYPE, sort_hits
from .step import dispatch_tick


def process_window_reference(adcs: np.ndarray, state: ChanState,
                             cfg: TPGConfig, tick_offset: int = 0):
    """Run the pipeline over a (T, C) int window, carrying state.

    Returns (hits, new_state); hits in canonical (end_tick, channel) order
    with end_tick offset by ``tick_offset`` (absolute-time assembly happens
    at the processor layer, WIBEthFrameProcessor.cpp:523-524).
    """
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    st = {k: np.asarray(v).copy() for k, v in state.items()}
    out = []
    for t in range(T):
        st, closed, rec = dispatch_tick(st, adcs[t], cfg, np)
        (idx,) = np.nonzero(closed)
        if len(idx):
            h = np.zeros(len(idx), dtype=HIT_DTYPE)
            h["channel"] = idx
            h["end_tick"] = t + tick_offset
            for f in ("charge", "tover", "peak_adc", "peak_time"):
                h[f] = rec[f][idx]
            out.append(h)
    hits = sort_hits(np.concatenate(out)) if out else np.zeros(0, dtype=HIT_DTYPE)
    return hits, ChanState(st)


def run_reference(adcs: np.ndarray, cfg: TPGConfig,
                  rs_memory_factor=None, window: int = 64):
    """Convenience: seed state from the first sample (setState semantics) and
    process (T, C) in `window`-tick chunks like the streaming harness does."""
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    if rs_memory_factor is None:
        rs_memory_factor = cfg.rs_memory_factor_x10
    cfg.check_memory_factors(rs_memory_factor)
    state = seed_chanstate(init_chanstate(C), adcs[0], rs_memory_factor)
    parts = []
    for t0 in range(0, T, window):
        hits, state = process_window_reference(adcs[t0:t0 + window], state,
                                               cfg, tick_offset=t0)
        parts.append(hits)
    all_hits = (sort_hits(np.concatenate(parts))
                if any(len(p) for p in parts) else np.zeros(0, dtype=HIT_DTYPE))
    return all_hits, state
