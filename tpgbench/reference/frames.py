"""WIBEth frames in the plain reference: layout constants and the unpack.

A frame is 7200 bytes: four 64-bit header words, then 64 ticks of 28
little-endian 32-bit words, each tick a bit stream of 64 channels x 14
bits (channel c at bits [14c, 14c + 14)).  Header word 0 carries the
DAQEthHeader bitfields, word 1 the 64-bit timestamp of the first tick.
"""

from __future__ import annotations

import numpy as np

FRAME_BYTES = 7200
CHANNELS = 64
TICKS = 64
WORDS_PER_TICK = 28
HEADER_U32 = 8
ADC_BITS = 14
CLOCKS_PER_TICK = 32
CLOCKS_PER_FRAME = CLOCKS_PER_TICK * TICKS

# DAQEthHeader word 0: name -> (lsb, width)
HEADER_FIELDS = {"det_id": (6, 6), "crate_id": (12, 10), "slot_id": (22, 4),
                 "stream_id": (26, 8), "seq_id": (40, 12)}


def unpack_adcs(frames: np.ndarray) -> np.ndarray:
    """(L, N, 7200) uint8 frames of one batch -> (N * 64, L * 64) int32
    samples, tick-major, channel l * 64 + c for channel c of link l."""
    L, N, nbytes = frames.shape
    if nbytes != FRAME_BYTES:
        raise ValueError(f"frames of {nbytes} bytes, expected {FRAME_BYTES}")
    words = np.ascontiguousarray(frames).view("<u4")[..., HEADER_U32:]
    words = words.reshape(L, N, TICKS, WORDS_PER_TICK).astype(np.int64)
    bit = ADC_BITS * np.arange(CHANNELS)
    lo_word, shift = bit // 32, bit % 32
    hi_word = np.minimum(lo_word + 1, WORDS_PER_TICK - 1)
    lo = words[..., lo_word] >> shift
    hi = np.where(shift + ADC_BITS > 32,
                  words[..., hi_word] << (32 - shift), 0)
    adcs = ((lo | hi) & ((1 << ADC_BITS) - 1)).astype(np.int32)
    # (L, N, tick, channel) -> (N * 64 ticks, L * 64 channels)
    return adcs.transpose(1, 2, 0, 3).reshape(N * TICKS, L * CHANNELS)


def header_field(frames: np.ndarray, name: str) -> np.ndarray:
    lsb, width = HEADER_FIELDS[name]
    w0 = np.ascontiguousarray(frames).view("<u8")[..., 0]
    return ((w0 >> np.uint64(lsb)) & np.uint64((1 << width) - 1)) \
        .astype(np.int64)


def timestamps(frames: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frames).view("<u8")[..., 1].astype(np.int64)
