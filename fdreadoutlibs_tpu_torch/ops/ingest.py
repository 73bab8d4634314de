"""Device ingest for the time2 host feed, and the one-fetch compaction.

Counterpart of ``fdreadoutlibs_tpu/ops/ingest.py::process_time2_feed``
(:150-183), ``compact_on_device`` (:279-296) and ``unpack_compact``
(:299-305).  The feed is the host codec's output as it is —
``native.relayout_time2(pad8=False)``: (T/2, ceil(C/128), 128) int32 with
adc(2t) | adc(2t+1) << 16 at flat lane c.  The JAX path zero-pads it to
whole 8-row sublane tiles on the device; that is a TPU tile rule, so the
port reads the unpadded rows directly (row stride ceil(C/128)*128).
"""

from __future__ import annotations

import numpy as np
import torch

from fdreadoutlibs_tpu.ops.config import TPGConfig
from fdreadoutlibs_tpu.ops.hits import hits_from_compact

from .hits import compact_slots
from .tpg import process_window


def process_time2_feed(W2: torch.Tensor, state: torch.Tensor,
                       cfg: TPGConfig, n_channels: int, tc: int = 512,
                       k_slots: int = 2):
    """Time-paired feed (T/2, S, 128) or (T/2, W) int32 -> (slots, nclose,
    new_state) like ``tpg.process_window``.  ``state`` is the (KSTATE, C)
    tensor of ``tpg.pack_state`` on the feed's device."""
    if W2.dim() == 3:
        W2 = W2.reshape(W2.shape[0], -1)
    if state.shape[1] != n_channels:
        raise ValueError(f"state holds {state.shape[1]} channels, "
                         f"expected {n_channels}")
    return process_window(W2, state, cfg, tc=tc, k_slots=k_slots,
                          time_packed=True)


def compact_on_device(slots, nclose, tick_offset: int, n_channels: int,
                      max_hits: int):
    """-> ONE (max_hits + 1, 6) int32 device tensor: the compact hit rows
    plus a trailer row [n_valid, dropped, 0...], so the host decode is a
    single device->host fetch.  Issues no host sync."""
    if slots.shape[-1] != n_channels:
        raise ValueError(f"slots hold {slots.shape[-1]} channels, "
                         f"expected {n_channels}")
    out, n, dropped = compact_slots(slots, nclose, max_hits,
                                    tick_offset=tick_offset)
    trailer = torch.zeros((1, 6), dtype=torch.int32, device=out.device)
    trailer[0, 0] = n
    trailer[0, 1] = dropped
    return torch.cat([out, trailer], dim=0)


def unpack_compact(packed):
    """compact_on_device output -> (canonical hit array, dropped count);
    the one device->host fetch + decode."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    n, dropped = int(packed[-1, 0]), int(packed[-1, 1])
    return hits_from_compact(packed[:-1], n), dropped
