"""WIB2 (DUNE-WIB) frame format.

Port copy of ``fdreadoutlibs_tpu/formats/wib2.py``: the same code apart
from imports, with the torch device unpack :func:`unpack_frames` in place
of the jnp ``unpack_frames_jnp`` (:142-148). It is carried here because
importing the original pulls in jax through its package's ``__init__``.

Geometry (reference: include/fdreadoutlibs/DUNEWIBSuperChunkTypeAdapter.hpp,
wib2/tpg/TPGConstants_wib2.hpp:17-44, FrameExpand.hpp:193-209 and the
standalone frame round-trip in test/apps/wib2_test_bench.cxx:182-254):

* one frame = 472 bytes = header (4 x 32-bit words) + adc_words[112]
  (uint32) + trailer (2 words); 256 channels x 14-bit ADCs packed
  little-endian in blocks of 7 words per 16 channels (same codec and
  in-register permutation as WIBEth);
* a superchunk = 12 frames = 5664 bytes; expected_tick_difference = 32
  per frame (DUNEWIBSuperChunkTypeAdapter.hpp:97);
* the AVX2 path expands half the channels at a time via a *register
  selector* (0 -> channels 0..127, 1 -> 128..255; FrameExpand.hpp:205:
  ``adc_words + 7*(iblock + selector*8)``);
* timestamp = header.timestamp_1 | timestamp_2 << 32 (32-bit words).

Header word 1 bitfields follow fddetdataformats WIB2Frame::Header.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack import pack_14bit, unpack_14bit, unpack_14bit_torch

FRAME_SIZE = 472                     # bytes
N_CHANNELS = 256
ADC_WORDS = 112                      # uint32 words of packed ADCs
HEADER_WORDS = 4                     # uint32
TRAILER_WORDS = 2
ADC_BITS = 14
FRAMES_PER_SUPERCHUNK = 12
SUPERCHUNK_SIZE = FRAME_SIZE * FRAMES_PER_SUPERCHUNK        # 5664
EXPECTED_TICK_DIFFERENCE = 32        # per frame
SUPERCHUNK_TICK_DIFFERENCE = EXPECTED_TICK_DIFFERENCE * FRAMES_PER_SUPERCHUNK
CHANNELS_PER_SELECTOR = 128          # register-selector half
FRAGMENT_TYPE = "kWIB"
SUBSYSTEM = "kDetectorReadout"

# header word 1 bitfields: name -> (lsb, width)
HEADER_FIELDS = {
    "version": (0, 4),
    "detector_id": (4, 6),
    "crate": (10, 10),
    "slot": (20, 4),
    "link": (24, 8),
}


def empty_frames(n: int = 1) -> np.ndarray:
    return np.zeros((n, FRAME_SIZE), dtype=np.uint8)


def empty_superchunks(n: int = 1) -> np.ndarray:
    return np.zeros((n, SUPERCHUNK_SIZE), dtype=np.uint8)


def superchunk_frames(superchunks: np.ndarray) -> np.ndarray:
    """View (..., 5664) superchunks as (..., 12, 472) frames."""
    return superchunks.reshape(*superchunks.shape[:-1],
                               FRAMES_PER_SUPERCHUNK, FRAME_SIZE)


def _words(frames: np.ndarray) -> np.ndarray:
    assert frames.dtype == np.uint8 and frames.shape[-1] == FRAME_SIZE
    return frames.view("<u4")


def get_timestamp(frames: np.ndarray) -> np.ndarray:
    w = _words(frames)
    return w[..., 2].astype(np.uint64) | (w[..., 3].astype(np.uint64) << np.uint64(32))


def set_timestamp(frames: np.ndarray, ts) -> None:
    w = _words(frames)
    ts = np.asarray(ts, dtype=np.uint64)
    w[..., 2] = (ts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    w[..., 3] = (ts >> np.uint64(32)).astype(np.uint32)


def get_header_field(frames: np.ndarray, name: str) -> np.ndarray:
    lsb, width = HEADER_FIELDS[name]
    w1 = _words(frames)[..., 1]
    return ((w1 >> np.uint32(lsb)) & np.uint32((1 << width) - 1)).astype(np.int64)


def set_header_field(frames: np.ndarray, name: str, value) -> None:
    lsb, width = HEADER_FIELDS[name]
    w = _words(frames)
    mask = np.uint32(((1 << width) - 1) << lsb)
    v = (np.asarray(value, dtype=np.uint32) << np.uint32(lsb)) & mask
    w[..., 1] = (w[..., 1] & ~mask) | v


def adc_region_u32(frames: np.ndarray) -> np.ndarray:
    return _words(frames)[..., HEADER_WORDS:HEADER_WORDS + ADC_WORDS]


def get_adcs(frames: np.ndarray) -> np.ndarray:
    """(..., 472) frames -> (..., 256) uint16 ADCs (frame channel order)."""
    return unpack_14bit(adc_region_u32(frames), N_CHANNELS, ADC_BITS)


def set_adcs(frames: np.ndarray, adcs: np.ndarray) -> None:
    adc_region_u32(frames)[...] = pack_14bit(adcs, ADC_BITS, n_words=ADC_WORDS)


def get_adc(frames: np.ndarray, channel: int) -> np.ndarray:
    return get_adcs(frames)[..., channel]


def set_adc(frames: np.ndarray, channel: int, value) -> None:
    adcs = get_adcs(frames).copy()
    adcs[..., channel] = value
    set_adcs(frames, adcs)


# ---- adapter duck interface ----------------------------------------------------

def fake_timestamps(superchunks: np.ndarray, first_timestamp: int,
                    offset: int = EXPECTED_TICK_DIFFERENCE) -> None:
    """Per-frame timestamps at +offset within each superchunk and
    +12*offset across superchunks (DUNEWIBSuperChunkTypeAdapter.hpp:48-57)."""
    frames = superchunk_frames(superchunks)
    n_chunks = frames.shape[0] if frames.ndim == 3 else 1
    idx = np.arange(n_chunks * FRAMES_PER_SUPERCHUNK, dtype=np.uint64)
    ts = np.uint64(first_timestamp) + idx * np.uint64(offset)
    set_timestamp(frames.reshape(-1, FRAME_SIZE), ts)


def fake_geoid(superchunks: np.ndarray, crate: int, slot: int, link: int) -> None:
    frames = superchunk_frames(superchunks).reshape(-1, FRAME_SIZE)
    set_header_field(frames, "crate", crate)
    set_header_field(frames, "slot", slot)
    set_header_field(frames, "link", link)


# ---- device-side unpack --------------------------------------------------------

def unpack_frames(words: torch.Tensor) -> torch.Tensor:
    """(..., 112) int32 ADC words -> (..., 256) int32 ADCs (frame order).

    Equivalent of expand_wib2_adcs over both register selectors
    (FrameExpand.hpp:193-209) in natural channel order.
    """
    return unpack_14bit_torch(words, N_CHANNELS, ADC_BITS)


def superchunk_bytes_to_u32(superchunks: np.ndarray) -> np.ndarray:
    """(..., 5664) uint8 -> (..., 12, 112) uint32 ADC words."""
    return np.ascontiguousarray(adc_region_u32(superchunk_frames(superchunks)))


def selector_channels(selector: int) -> np.ndarray:
    """Frame channels covered by a register selector half (0 or 1)."""
    return np.arange(CHANNELS_PER_SELECTOR) + selector * CHANNELS_PER_SELECTOR


# In-register channel permutation — identical to WIBEth (the AVX unpacker is
# shared; wib2_test_bench.cxx:237 uses the same indices array).
PERMUTATION = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 8, 9, 10, 11, 12, 13, 14])


def register_order_channels(selector: int) -> np.ndarray:
    """Frame-channel index held by each reference register lane for a
    selector half: lane 16*r + j of the 8-register MessageRegisters holds
    frame channel selector*128 + 16*r + PERMUTATION[j]
    (expand_wib2_adcs, FrameExpand.hpp:205)."""
    regs = np.arange(CHANNELS_PER_SELECTOR) // 16
    lanes = np.arange(CHANNELS_PER_SELECTOR) % 16
    return selector * CHANNELS_PER_SELECTOR + regs * 16 + PERMUTATION[lanes]


def to_register_order(adcs: np.ndarray, selector: int) -> np.ndarray:
    """(..., 256) frame-order ADCs -> (..., 128) reference register layout
    for the given selector half."""
    return adcs[..., register_order_channels(selector)]
