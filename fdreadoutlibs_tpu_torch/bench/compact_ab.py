"""The app's compaction cell: the port's ``ops/hits`` top-k compaction
against the sort form, in ms per batch of the app's device work.

Counterpart of ``scripts/bench_compact_ab.py``: at the app's shapes (40
links x 128 frames, AbsRS 150 with threshold-on-collection memory factors,
the time2 feed), the kernel alone at k_slots 1, then the kernel and the
compaction for {top-k, sort} x {k_slots 1, 4}, in turns within each trial,
on two resident feeds, state chained; the top-k rows must equal the sort
form's on both feeds.  ``sort_compact_slot_words`` is the sort form kept as
the A/B baseline (a full stable argsort over every slot and a gather of
the first ``max_hits`` rows); ``ops/hits.compact_slot_words`` is the one
the app runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import wibeth
from ..ops import TPGConfig, ingest
from ..ops.tpg import auto_tc
from ..utils.tuning import kernel_knobs
from . import time_chain
from .app_rtf import ALGORITHM, THRESHOLD, device_inputs

_INVALID = torch.iinfo(torch.int64).max
# the app's shapes (bench_compact_ab.py:77-78)
LINKS, FRAMES = 40, 128


def sort_compact_slot_words(w0, w1, w2, max_hits: int):
    """(K, C) record words -> ((max_hits, 6) int32 hits in (end_tick,
    channel) order, valid count) by a stable argsort of every slot."""
    K, C = w2.shape
    dev = w2.device
    valid = (w2 != 0).reshape(-1)
    chan = torch.arange(C, dtype=torch.int32, device=dev).repeat(K)
    end = (w2 - 1).reshape(-1)
    if w1 is None:
        w1 = torch.zeros_like(w0)
    w0, w1 = w0.reshape(-1), w1.reshape(-1)
    fields = torch.stack([chan, end, w0 >> 16, w0 & 0xFFFF,
                          w1 >> 16, w1 & 0xFFFF], dim=-1)
    key = torch.where(valid, end.long() * C + chan.long(), _INVALID)
    order = torch.argsort(key, stable=True)
    fields, valid = fields[order], valid[order]
    n = valid.sum(dtype=torch.int32)
    out = torch.zeros((max_hits, 6), dtype=torch.int32, device=dev)
    take = min(max_hits, K * C)
    out[:take] = torch.where(valid[:take, None], fields[:take], 0)
    return out, torch.clamp(n, max=max_hits)


def sort_compact(slots, nclose, n_channels: int, max_hits: int):
    """``compact_on_device``'s rows and trailer count by the sort form."""
    nch, K, nw, C = slots.shape
    flat = slots.reshape(nch * K, nw, C)[:, :, :n_channels]
    w1 = flat[:, 1] if nw == 3 else None
    out, n = sort_compact_slot_words(flat[:, 0], w1, flat[:, -1], max_hits)
    trailer = torch.zeros((1, 6), dtype=torch.int32, device=out.device)
    trailer[0, 0] = n
    return torch.cat([out, trailer], dim=0)


def run(trials: int = 5, device="cuda") -> dict:
    """{"<arm>_ms": ms per batch, "<arm>_rtf": span / ms} for the arms
    kernel_k1, topk_k1, sort_k1, topk_k4 and sort_k4 (the medians of
    ``trials`` chains of 7 batches each, the arms in turns)."""
    device = torch.device(device)
    L, N = LINKS, FRAMES
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    # the app's family (bench_compact_ab.py:80, :102)
    cfg = TPGConfig.from_raw(ALGORITHM, threshold=THRESHOLD)
    knobs = kernel_knobs(cfg)
    state0, feeds = device_inputs(L, N, cfg, device)
    tc = auto_tc(T, cap=knobs["tc"])
    max_hits = max(2048, 2 * C)
    span_ms = T / (62.5e6 / 32) * 1e3

    def make_step(k_slots, compact):
        def step(feed, state):
            slots, nclose, state = ingest.process_time2_feed(
                feed, state, cfg, C, tc=tc, k_slots=k_slots,
                fir_twopass=knobs["fir_twopass"], geometry=knobs["geometry"])
            if compact == "topk":
                return ingest.compact_on_device(slots, nclose, 0, C,
                                                max_hits), state
            if compact == "sort":
                return sort_compact(slots, nclose, C, max_hits), state
            return nclose, state
        return step

    arms = {"kernel_k1": make_step(1, None), "topk_k1": make_step(1, "topk"),
            "sort_k1": make_step(1, "sort"), "topk_k4": make_step(4, "topk"),
            "sort_k4": make_step(4, "sort")}
    # the top-k rows equal the sort form's on this very data
    for k in ("k1", "k4"):
        for f in feeds:
            a = arms["topk_" + k](f, state0)[0]
            b = arms["sort_" + k](f, state0)[0]
            if int(a[-1, 0]) <= 0:
                raise AssertionError("no hit reached the compaction")
            if not (torch.equal(a[:-1], b[:-1]) and
                    int(a[-1, 0]) == int(b[-1, 0])):
                raise AssertionError(f"top-k and sort compaction differ "
                                     f"({k})")
    results = {name: [] for name in arms}
    for _ in range(trials):
        for name, step in arms.items():
            results[name] += time_chain(
                lambda s, i, step=step: step(feeds[i % 2], s)[1], state0, 7,
                1, device)
    out = {"metric": "compact_ab", "links": L, "frames": N, "tc": tc,
           "max_hits": max_hits, "span_ms": round(span_ms, 3)}
    for name, per in results.items():
        ms = float(np.median(per)) * 1e3
        out[name + "_ms"] = round(ms, 4)
        out[name + "_rtf"] = round(span_ms / ms, 2)
    return out
