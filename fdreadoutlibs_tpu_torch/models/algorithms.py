"""SWTPG model-family registry.

Port copy of ``fdreadoutlibs_tpu/models/algorithms.py``: the registry is
the same code; :func:`run_model` runs the port's backends on an explicit
``device``.

| family          | reference kernel                      | filter stage      |
|-----------------|---------------------------------------|-------------------|
| SimpleThreshold | process_window_avx2 (wibeth)          | none (fixed thr)  |
| AbsRS           | process_window_rs_avx2                | |s| running sum   |
| StandardRS      | process_window_standard_rs_avx2       | signed running sum|
| FIR             | process_window_avx2 (wib), AVX2FIR    | 8-tap FIR + IQR   |
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..formats.trigprim import TPAlgorithm
from ..ops import Algorithm, TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate


@dataclass(frozen=True)
class ModelFamily:
    name: str
    algorithm: Algorithm
    tp_algorithm: TPAlgorithm
    description: str
    uses_rs_state: bool = False
    uses_fir_state: bool = False
    dynamic_threshold: bool = False


MODEL_FAMILIES = {
    "SimpleThreshold": ModelFamily(
        "SimpleThreshold", Algorithm.SIMPLE_THRESHOLD,
        TPAlgorithm.kSimpleThreshold,
        "Frugal pedestal subtraction + fixed threshold "
        "(wibeth/tpg/ProcessAVX2.hpp)"),
    "AbsRS": ModelFamily(
        "AbsRS", Algorithm.ABS_RS, TPAlgorithm.kAbsRunningSum,
        "Absolute running sum, x10 fixed point "
        "(wibeth/tpg/ProcessAbsRSAVX2.hpp)", uses_rs_state=True),
    "StandardRS": ModelFamily(
        "StandardRS", Algorithm.STANDARD_RS, TPAlgorithm.kRunningSum,
        "Signed running sum (wibeth/tpg/ProcessStandardRSAVX2.hpp)",
        uses_rs_state=True),
    "FIR": ModelFamily(
        "FIR", Algorithm.FIR, TPAlgorithm.kSimpleThreshold,
        "8-tap FIR + IQR dynamic threshold (wib/wib2 legacy kernels)",
        uses_fir_state=True, dynamic_threshold=True),
}

# the "pallas" backend's windows and per-window hit capacity
# (algorithms.py:107-111)
WINDOW = 512
K_SLOTS = 8


def get_model(name: str) -> ModelFamily:
    if name not in MODEL_FAMILIES:
        from ..stream.errors import TPGAlgorithmInexistent
        raise TPGAlgorithmInexistent(
            f"unknown TPG algorithm {name!r} "
            f"(available: {sorted(MODEL_FAMILIES)})")
    return MODEL_FAMILIES[name]


def run_model(adcs: np.ndarray, cfg: TPGConfig, backend: str = "scan",
              state: Optional[dict] = None, rs_memory_factor=None,
              device="cuda"):
    """One-call model execution over a (T, C) stream; returns (hits, state).

    Backends: "reference" (the numpy oracle), "scan" (``ops.scan.
    process_window_scan`` on ``device``, the port of the JAX package's
    dense scan: plain PyTorch that keeps every close, chosen only by this
    name) and "pallas" (``ops.tpg.process_window``
    on ``device``: the hand-written kernels on "cuda", their plain versions
    on "cpu"; windows of 512 ticks, one chunk each, 8 hits per channel per
    window, the FIR schedule of ``kernel_knobs``).  ``device`` is unused by
    "reference".
    """
    from ..ops.ingest import decode_slots
    from ..ops.tpg import pack_state, process_window, unpack_state
    adcs = np.asarray(adcs, dtype=np.int32)
    T, C = adcs.shape
    if rs_memory_factor is None:
        rs_memory_factor = cfg.rs_memory_factor_x10
    if state is None:
        cfg.check_memory_factors(rs_memory_factor)
        state = seed_chanstate(init_chanstate(C), adcs[0], rs_memory_factor)

    if backend == "reference":
        from ..ops.reference import process_window_reference
        return process_window_reference(adcs, state, cfg)
    if backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    from ..apps.apa_readout import resolve_device
    from ..utils.tuning import kernel_knobs
    dev = resolve_device(device)
    # a transposed caller's array (a TDE cycle) is a strided view: the
    # kernel takes contiguous rows
    x = torch.from_numpy(np.ascontiguousarray(adcs)).to(dev)
    state = dict(state)
    if backend == "scan":
        from ..ops.hits import decode_dense
        from ..ops.scan import (process_window_scan, state_to_numpy,
                                state_to_torch)
        closed, records, st = process_window_scan(
            x, state_to_torch(state, dev), cfg)
        state.update(state_to_numpy(st))
        return decode_dense(closed, records), state
    st = pack_state(state, C, device=dev)
    knobs = kernel_knobs(cfg)
    twopass = knobs["fir_twopass"]
    parts = []
    for t0 in range(0, T, WINDOW):
        w = min(WINDOW, T - t0)
        slots, nclose, st = process_window(
            x[t0:t0 + w], st, cfg, tc=w, k_slots=K_SLOTS,
            time_packed=False, fir_twopass=twopass,
            geometry=knobs["geometry"])
        parts.append(decode_slots(slots, nclose, C, tick_offset=t0)[0])
    from ..ops.hits import concat_hits
    state.update(unpack_state(st))
    return concat_hits(parts), state
