"""Device ingest entry points, and the hit collection.

Counterparts of ``fdreadoutlibs_tpu/ops/ingest.py``:

* :func:`process_time2_feed` (:150-183) takes the host codec's time2 feed
  as it is, ``native.relayout_time2(pad8=False)``: (T/2, ceil(C/128), 128)
  int32 with adc(2t) | adc(2t+1) << 16 at flat lane c;
* :func:`process_packed_frames` (:35-62) and :func:`process_packed_wib2`
  (:190-209) unpack packed 14-bit frame words on the device and run the
  plain-sample datapath on a (T, C) int32 feed;
* :func:`compact_on_device` (:279-296), :func:`unpack_compact` (:299-305)
  and :func:`collect_hits` (:308-331) turn the slot buffers into hits.

The JAX path pads the channel axis to whole 8-row sublane tiles on the
device; that is a TPU tile rule, so the port reads unpadded rows directly.
"""

from __future__ import annotations

import numpy as np
import torch

from fdreadoutlibs_tpu.ops.config import TPGConfig
from fdreadoutlibs_tpu.ops.hits import HIT_DTYPE, hits_from_compact, sort_hits

from ..formats import wib2, wibeth
from .hits import compact_slots
from .tpg import process_window


def _check_channels(state: torch.Tensor, n_channels: int) -> None:
    if state.shape[1] != n_channels:
        raise ValueError(f"state holds {state.shape[1]} channels, "
                         f"expected {n_channels}")


def process_time2_feed(W2: torch.Tensor, state: torch.Tensor,
                       cfg: TPGConfig, n_channels: int, tc: int = 512,
                       k_slots: int = 2):
    """Time-paired feed (T/2, S, 128) or (T/2, W) int32 -> (slots, nclose,
    new_state) like ``tpg.process_window``.  ``state`` is the (KSTATE, C)
    tensor of ``tpg.pack_state`` on the feed's device."""
    if W2.dim() == 3:
        W2 = W2.reshape(W2.shape[0], -1)
    _check_channels(state, n_channels)
    return process_window(W2, state, cfg, tc=tc, k_slots=k_slots,
                          time_packed=True)


def process_packed_frames(words: torch.Tensor, state: torch.Tensor,
                          cfg: TPGConfig, n_channels: int, tc: int = 512,
                          k_slots: int = 2):
    """WIBEth packed ingest: words (L, T, 28) int32 packed rows for L links
    of 64 channels -> device unpack -> (T, L*64) samples (channel =
    link*64 + c) -> the plain-sample datapath.  Returns (slots, nclose,
    new_state) like ``tpg.process_window``."""
    _check_channels(state, n_channels)
    L, T, _ = words.shape
    adcs = wibeth.unpack_frames(words.transpose(0, 1))      # (T, L, 64)
    return process_window(adcs.reshape(T, L * wibeth.N_CHANNELS), state,
                          cfg, tc=tc, k_slots=k_slots, time_packed=False)


def process_packed_wib2(words: torch.Tensor, state: torch.Tensor,
                        cfg: TPGConfig, n_channels: int, tc: int = 512,
                        k_slots: int = 4):
    """WIB2 packed ingest: words (L, T, 112) int32 packed rows (each WIB2
    frame is ONE tick of 256 channels) -> device unpack -> (T, L*256)
    samples (channel = link*256 + c) -> the plain-sample datapath."""
    _check_channels(state, n_channels)
    L, T, _ = words.shape
    adcs = wib2.unpack_frames(words.transpose(0, 1))        # (T, L, 256)
    return process_window(adcs.reshape(T, L * wib2.N_CHANNELS), state, cfg,
                          tc=tc, k_slots=k_slots, time_packed=False)


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


def decode_slots(slots, nclose, n_channels: int, tick_offset: int = 0):
    """Host decode of the port's slot layout -> (canonical hit array,
    dropped count): the counterpart of ``pallas_tpg.decode_pallas_hits``
    (:956-995).  slots (NCH, K, nw, C), nclose (NCH, C); nw = 2 is the
    no-peak FIR record [w0, end+1].  Dropped counts closes beyond the K
    slots of a channel's chunk."""
    slots = torch.as_tensor(slots).cpu().numpy()
    nclose = torch.as_tensor(nclose).cpu().numpy()
    nch, K, nw, _ = slots.shape
    flat = slots.reshape(nch * K, nw, -1)[:, :, :n_channels]
    k_idx, c_idx = np.nonzero(flat[:, -1] != 0)
    hits = np.zeros(len(k_idx), dtype=HIT_DTYPE)
    w0 = flat[k_idx, 0, c_idx]
    hits["channel"] = c_idx
    hits["end_tick"] = flat[k_idx, -1, c_idx] - 1 + tick_offset
    hits["charge"] = w0 >> 16
    hits["tover"] = w0 & 0xFFFF
    if nw == 3:
        w1 = flat[k_idx, 1, c_idx]
        hits["peak_adc"] = w1 >> 16
        hits["peak_time"] = w1 & 0xFFFF
    dropped = int(np.maximum(nclose[:, :n_channels] - K, 0).sum())
    return sort_hits(hits), dropped


def collect_hits(slots, nclose, n_channels: int, max_hits: int | None = None,
                 tick_offset: int = 0, device: bool = True):
    """Kernel slot outputs -> (canonical hit array, dropped count).

    device=True compacts on the device and fetches only the hit list (one
    device->host copy); device=False fetches the slot buffers and decodes
    them on the host (:func:`decode_slots`, always lossless).  The two
    agree whenever the valid hits fit ``max_hits`` (None -> max(2048, 2x
    the channel count)); overflow beyond it is counted as dropped."""
    if max_hits is None:
        max_hits = max(2048, 2 * n_channels)
    if device:
        return unpack_compact(compact_on_device(slots, nclose, tick_offset,
                                                n_channels, max_hits))
    return decode_slots(slots, nclose, n_channels, tick_offset=tick_offset)
