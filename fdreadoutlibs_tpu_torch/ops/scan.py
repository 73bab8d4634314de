"""The portable SWTPG backend: a loop over ticks with the ChanState carry.

Counterpart of ``fdreadoutlibs_tpu/ops/scan.py:1-86``, the JAX package's
XLA backend (a ``lax.scan``, not a Pallas kernel).  Here it is plain
PyTorch on the caller's device: each tick calls the port's
``ops/step.py::dispatch_tick`` on (C,) int32 tensors (``ops/xp.TorchXP``),
so it is bit-exact against the numpy oracle and the JAX scan, which run
the same tick.  It keeps every close: the outputs are dense per-tick
(T, C) closed masks and record fields, decoded by
:func:`ops.hits.decode_dense` or compacted on the device by
:func:`compact_hits_device` (a prefix sum and a scatter, with the overflow
beyond ``max_hits`` dropped and counted).

This backend is chosen by name only (``tpg_backend="scan"``,
``run_model(backend="scan")``): the kernel route is "pallas".
"""

from __future__ import annotations

import numpy as np
import torch

from .chanstate import FIELDS
from .config import TPGConfig
from .step import dispatch_tick
from .xp import TorchXP, make_fx

STATE_KEYS = FIELDS + ("rs_memory_factor", "fir_prev")
RECORD_FIELDS = ("charge", "tover", "peak_adc", "peak_time")


def state_to_torch(state, device="cpu") -> dict:
    """ChanState dict -> {STATE_KEYS: int32 tensors on ``device``} (the
    counterpart of ``state_to_jnp``, :23-24)."""
    return {k: torch.as_tensor(np.asarray(state[k], dtype=np.int32),
                               device=device) for k in STATE_KEYS}


def state_to_numpy(state: dict) -> dict:
    """The scan's state tensors -> {STATE_KEYS: int32 numpy arrays}."""
    return {k: v.cpu().numpy() for k, v in state.items()}


def process_window_scan(adcs: torch.Tensor, state: dict, cfg: TPGConfig):
    """(T, C) integer window -> (closed (T, C) bool, records dict of (T, C)
    int32, new_state), on the device of ``adcs`` (:27-48).

    ``state`` is a dict of (C,) int32 tensors (and ``fir_prev`` (8, C)) on
    that device, as :func:`state_to_torch` makes it; it is not modified."""
    adcs = adcs.to(torch.int32)
    dev = adcs.device
    xp = TorchXP(dev)
    fx = make_fx(xp)
    st = {k: torch.as_tensor(state[k], dtype=torch.int32, device=dev)
          for k in STATE_KEYS}
    # the FIR ring rides as a tuple of rows (a rotation per tick)
    st["fir_prev"] = tuple(st["fir_prev"].unbind(0))
    T = adcs.shape[0]
    closed = []
    records = {f: [] for f in RECORD_FIELDS}
    for t in range(T):
        st, c, rec = dispatch_tick(st, adcs[t], cfg, xp, fx=fx)
        closed.append(c)
        for f in RECORD_FIELDS:
            records[f].append(rec[f])
    st["fir_prev"] = torch.stack(st["fir_prev"])
    C = adcs.shape[1]

    def dense(rows, dtype):
        return torch.stack(rows) if rows else \
            torch.zeros((0, C), dtype=dtype, device=dev)

    records = {f: dense(v, torch.int32) for f, v in records.items()}
    return dense(closed, torch.bool), records, \
        {k: st[k] for k in STATE_KEYS}


def compact_hits_device(closed: torch.Tensor, records: dict,
                        max_hits: int = 1024):
    """Device-side compaction of dense (..., T, C) hit outputs to fixed
    capacity (:51-75): a prefix sum gives each closed (t, c) its slot in
    close order, which is the canonical (end_tick, channel) order; the
    overflow beyond ``max_hits`` is dropped and counted.  Leading axes are
    compacted apart in one pass (the JAX package ``vmap``s it per link,
    ``parallel/apa.py:180-183``).  Issues no host sync.

    Returns (hits (..., max_hits, 6) int32 [channel, end_tick, charge,
    tover, peak_adc, peak_time], n_hits (...,), n_dropped (...,))."""
    *lead, T, C = closed.shape
    dev = closed.device
    flat = closed.reshape(*lead, T * C)
    ones = flat.to(torch.int32)
    pos = torch.cumsum(ones, -1, dtype=torch.int32) - 1
    n = ones.sum(dim=-1, dtype=torch.int32)
    idx = torch.arange(T * C, dtype=torch.int32, device=dev) \
        .expand(*lead, T * C)
    fields = [idx % C, idx // C] + [
        records[f].reshape(*lead, T * C).to(torch.int32)
        for f in RECORD_FIELDS]
    # a row that is not kept goes to the spare row max_hits, then dropped
    dest = torch.where(flat & (pos < max_hits), pos,
                       torch.full_like(pos, max_hits)).long()
    vals = torch.stack(fields, dim=-1)
    out = torch.zeros((*lead, max_hits + 1, 6), dtype=torch.int32,
                      device=dev)
    out.scatter_(-2, dest[..., None].expand(*lead, T * C, 6), vals)
    n_kept = torch.clamp(n, max=max_hits)
    return out[..., :max_hits, :], n_kept, n - n_kept


def compact_to_numpy(hits_arr, n_hits) -> np.ndarray:
    """Device compaction output -> the canonical structured array
    (:78-86)."""
    from .hits import HIT_DTYPE, sort_hits
    arr = torch.as_tensor(hits_arr).cpu().numpy()[: int(n_hits)]
    hits = np.zeros(len(arr), dtype=HIT_DTYPE)
    for i, f in enumerate(HIT_DTYPE.names):
        hits[f] = arr[:, i]
    return sort_hits(hits)
