"""Hit records: the canonical host array, and the on-device compaction of
the kernel's K-slot buffers.

The host side (``HIT_DTYPE``, ``empty_hits``, ``sort_hits``,
``decode_dense``, ``concat_hits``, ``hits_from_compact``) is copied from the
jax-free parts of ``fdreadoutlibs_tpu/ops/hits.py:14-43, 69-73, 155-161``,
unchanged but for ``decode_dense`` taking tensors on any device too (the
outputs of ``ops/scan.py``).

The device side is the counterpart of that file's ``compact_slot_words``
and ``compact_pallas_slots`` (there an XLA ``lax.top_k``, not a Pallas
kernel, so the port keeps it plain torch).  A fixed-size ``torch.topk``
replaces the variable-size ``torch.nonzero`` on purpose: nonzero syncs the
host, and the compaction must stay one asynchronous device pass ending in
ONE device->host fetch (``ops/ingest.py::unpack_compact``).

Keys are int64 ``end*C + chan``, so the canonical (end_tick, channel)
order holds at any T·C (the JAX package's int32 key wraps once
T·C >= 2**31).
"""

from __future__ import annotations

import numpy as np
import torch

HIT_DTYPE = np.dtype([
    ("channel", np.int32),     # channel index within the processed array
    ("end_tick", np.int32),    # tick at which the hit *closed* (first not-over)
    ("charge", np.int32),
    ("tover", np.int32),
    ("peak_adc", np.int32),
    ("peak_time", np.int32),   # tover value at the peak sample
])


def empty_hits() -> np.ndarray:
    return np.zeros(0, dtype=HIT_DTYPE)


def sort_hits(hits: np.ndarray) -> np.ndarray:
    """Canonical order: (end_tick, channel)."""
    return hits[np.lexsort((hits["channel"], hits["end_tick"]))]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_dense(closed, records: dict, tick_offset: int = 0) -> np.ndarray:
    """Decode dense per-tick outputs: closed (T, C) bool, records dict of
    (T, C) arrays or tensors -> canonical hit array."""
    t_idx, c_idx = np.nonzero(_host(closed))
    hits = np.zeros(len(t_idx), dtype=HIT_DTYPE)
    hits["channel"] = c_idx
    hits["end_tick"] = t_idx + tick_offset
    for f in ("charge", "tover", "peak_adc", "peak_time"):
        hits[f] = _host(records[f])[t_idx, c_idx]
    return sort_hits(hits)


def concat_hits(parts) -> np.ndarray:
    parts = [p for p in parts if len(p)]
    if not parts:
        return empty_hits()
    return sort_hits(np.concatenate(parts))


def hits_from_compact(rows: np.ndarray, count: int) -> np.ndarray:
    """(max_hits, 6) int32 device-compact output -> canonical hit array."""
    rows = np.asarray(rows)[:int(count)]
    hits = np.zeros(len(rows), dtype=HIT_DTYPE)
    for i, f in enumerate(HIT_DTYPE.names):
        hits[f] = rows[:, i]
    return hits


# ---- device-side compaction -----------------------------------------------

_INVALID = torch.iinfo(torch.int64).max


def compact_slot_words(w0, w1, w2, max_hits: int, channel_base: int = 0,
                       tick_offset: int = 0):
    """K-slot record words -> ((..., max_hits, 6) int32 hits [channel,
    end_tick, charge, tover, peak_adc, peak_time] in canonical (end_tick,
    channel) order, valid count (...,)), each leading index on its own.

    w0/w2: (..., K, C) packed words ([charge<<16|tover], [end_tick+1]);
    ``w1`` may be None (no-peak record layout) — peak fields emit as zero.
    Leading axes are compacted apart in one pass (the per-link compaction
    of ``parallel/apa.py``, the counterpart of the JAX package's ``vmap``).
    """
    *lead, K, C = w2.shape
    dev = w2.device
    valid = (w2 != 0).reshape(*lead, K * C)
    chan = torch.arange(C, dtype=torch.int32, device=dev).repeat(K) \
        .expand(*lead, K * C)
    end = (w2 - 1).reshape(*lead, K * C)
    if w1 is None:
        w1 = torch.zeros_like(w0)
    # valid keys are unique (a hit closes once per channel per tick), so
    # ties only ever occur among the invalid keys, whose rows are zeroed
    key = torch.where(valid, end.long() * C + chan.long(), _INVALID)
    take = min(max_hits, K * C)
    order = torch.topk(key, take, dim=-1, largest=False, sorted=True).indices

    def pick(x):
        return torch.gather(x.reshape(*lead, K * C), -1, order)

    valid_t = pick(valid)
    w0o, w1o = pick(w0), pick(w1)
    fields = torch.stack([pick(chan) + channel_base,
                          pick(end) + tick_offset,
                          w0o >> 16, w0o & 0xFFFF,
                          w1o >> 16, w1o & 0xFFFF], dim=-1)
    n = valid.sum(dim=-1, dtype=torch.int32)
    out = torch.zeros((*lead, max_hits, 6), dtype=torch.int32, device=dev)
    out[..., :take, :] = torch.where(valid_t[..., None], fields, 0)
    return out, torch.clamp(n, max=max_hits)


def compact_slots(slots, nclose, max_hits: int, tick_offset: int = 0):
    """``process_window`` outputs -> ((max_hits, 6) canonical hits, valid
    count, dropped count), entirely on device.  Dropped = closes beyond
    K per channel per chunk + valid hits beyond ``max_hits``."""
    nch, K, nw, C = slots.shape
    flat = slots.reshape(nch * K, nw, C)       # chunk-major slot axis
    w1 = flat[:, 1] if nw == 3 else None
    out, n = compact_slot_words(flat[:, 0], w1, flat[:, -1], max_hits,
                                tick_offset=tick_offset)
    dropped = torch.clamp(nclose - K, min=0).sum()
    total_valid = (flat[:, -1] != 0).sum()
    dropped = dropped + torch.clamp(total_valid - max_hits, min=0)
    return out, n, dropped
