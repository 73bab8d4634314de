"""DAPHNE photon-detector (PDS) frame formats — self-triggered and streaming.

Port copy of ``fdreadoutlibs_tpu/formats/daphne.py:1-184``: the same code
apart from imports, with the torch device unpack
:func:`stream_unpack_frames` in place of the jnp ``stream_unpack_frames_jnp``
(:138-149). It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Geometry (reference: include/fdreadoutlibs/DAPHNESuperChunkTypeAdapter.hpp,
DAPHNEStreamSuperChunkTypeAdapter.hpp; src/daphne/*.cpp):

* self-triggered DAPHNEFrame = 1816 bytes: DAQHeader (3 x 32-bit words:
  bitfield word + timestamp_1 + timestamp_2) + trigger header (1 word) +
  1024 samples x 14-bit packed waveform (1792 bytes) + trailer (2 words);
  a superchunk = 12 frames = 21792 bytes; expected_tick_difference = 16
  (self-triggered — arrival rate is not fixed, the processor's timestamp
  check is informational only, DAPHNEFrameProcessor.cpp:54-59); the
  emulator fakes +192 per superchunk with +16 per frame (cpp:39-47);
* streaming DAPHNEStreamFrame = 472 bytes: DAQHeader (3 words) + header
  (1 word) + 4 channels x 64 samples x 14-bit (448 bytes) + trailer
  (2 words); superchunk = 12 frames = 5664 bytes;
  expected_tick_difference = 64 (one frame spans 64 samples).

The adapter accesses timestamps as two 32-bit words
(daq_header.timestamp_1/timestamp_2, DAPHNESuperChunkTypeAdapter.hpp:41-57).
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack import pack_14bit, unpack_14bit, unpack_14bit_torch

# --- self-triggered ---
FRAME_SIZE = 1816
N_SAMPLES = 1024                       # waveform samples per frame
FRAMES_PER_SUPERCHUNK = 12
SUPERCHUNK_SIZE = FRAME_SIZE * FRAMES_PER_SUPERCHUNK      # 21792
EXPECTED_TICK_DIFFERENCE = 16
ADC_BITS = 14
HEADER_WORDS = 4                       # DAQHeader (3) + trigger header (1)
ADC_WORDS = N_SAMPLES * ADC_BITS // 32                    # 448
FRAGMENT_TYPE = "kDAPHNE"

# --- streaming ---
STREAM_FRAME_SIZE = 472
STREAM_N_CHANNELS = 4
STREAM_N_SAMPLES = 64
STREAM_FRAMES_PER_SUPERCHUNK = 12
STREAM_SUPERCHUNK_SIZE = STREAM_FRAME_SIZE * STREAM_FRAMES_PER_SUPERCHUNK  # 5664
STREAM_EXPECTED_TICK_DIFFERENCE = 64
STREAM_ADC_WORDS = STREAM_N_CHANNELS * STREAM_N_SAMPLES * ADC_BITS // 32   # 112
STREAM_FRAGMENT_TYPE = "kDAPHNEStream"

DAQ_HEADER_FIELDS = {
    "version": (0, 6),
    "det_id": (6, 6),
    "crate_id": (12, 10),
    "slot_id": (22, 4),
    "link_id": (26, 6),
}


def _frame_ops(frame_size: int, header_words: int, adc_words: int):
    """Build the shared accessor set for a DAPHNE-family frame layout."""

    def empty(n=1):
        return np.zeros((n, frame_size), dtype=np.uint8)

    def words(frames):
        assert frames.shape[-1] == frame_size
        return frames.view("<u4")

    def get_timestamp(frames):
        w = words(frames)
        return w[..., 1].astype(np.uint64) | \
            (w[..., 2].astype(np.uint64) << np.uint64(32))

    def set_timestamp(frames, ts):
        w = words(frames)
        ts = np.asarray(ts, dtype=np.uint64)
        w[..., 1] = (ts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        w[..., 2] = (ts >> np.uint64(32)).astype(np.uint32)

    def get_header_field(frames, name):
        lsb, width = DAQ_HEADER_FIELDS[name]
        w0 = words(frames)[..., 0]
        return ((w0 >> np.uint32(lsb)) & np.uint32((1 << width) - 1)).astype(np.int64)

    def set_header_field(frames, name, value):
        lsb, width = DAQ_HEADER_FIELDS[name]
        w = words(frames)
        mask = np.uint32(((1 << width) - 1) << lsb)
        v = (np.asarray(value, dtype=np.uint32) << np.uint32(lsb)) & mask
        w[..., 0] = (w[..., 0] & ~mask) | v

    def adc_region(frames):
        return words(frames)[..., header_words:header_words + adc_words]

    return empty, get_timestamp, set_timestamp, get_header_field, \
        set_header_field, adc_region


(empty_frames, get_timestamp, set_timestamp, get_header_field,
 set_header_field, _adc_region) = _frame_ops(FRAME_SIZE, HEADER_WORDS,
                                             ADC_WORDS)

(stream_empty_frames, stream_get_timestamp, stream_set_timestamp,
 stream_get_header_field, stream_set_header_field,
 _stream_adc_region) = _frame_ops(STREAM_FRAME_SIZE, HEADER_WORDS,
                                  STREAM_ADC_WORDS)


# ---- waveforms -----------------------------------------------------------------

def get_waveform(frames: np.ndarray) -> np.ndarray:
    """Self-triggered frame -> (..., 1024) uint16 waveform."""
    return unpack_14bit(_adc_region(frames), N_SAMPLES, ADC_BITS)


def set_waveform(frames: np.ndarray, samples: np.ndarray) -> None:
    _adc_region(frames)[...] = pack_14bit(samples, ADC_BITS, n_words=ADC_WORDS)


def stream_get_adcs(frames: np.ndarray) -> np.ndarray:
    """Streaming frame -> (..., 64 samples, 4 channels) uint16."""
    flat = unpack_14bit(_stream_adc_region(frames),
                        STREAM_N_CHANNELS * STREAM_N_SAMPLES, ADC_BITS)
    return flat.reshape(*frames.shape[:-1], STREAM_N_SAMPLES, STREAM_N_CHANNELS)


def stream_set_adcs(frames: np.ndarray, adcs: np.ndarray) -> None:
    flat = np.asarray(adcs).reshape(*frames.shape[:-1],
                                    STREAM_N_CHANNELS * STREAM_N_SAMPLES)
    _stream_adc_region(frames)[...] = pack_14bit(flat, ADC_BITS,
                                                 n_words=STREAM_ADC_WORDS)


def stream_frames_bytes_to_u32(frames_u8: np.ndarray) -> np.ndarray:
    """Host helper: (..., 472) uint8 stream frames -> (..., 112) uint32 ADC
    words (a view-level reshape; no decoding on host)."""
    return np.ascontiguousarray(_stream_adc_region(frames_u8))


def stream_unpack_frames(words: torch.Tensor) -> torch.Tensor:
    """Device unpack: (..., 112) int32 (or uint32) words -> (..., 64
    samples, 4 channels) int32, on the words' device — the counterpart of
    ``stream_unpack_frames_jnp``.  A frame's 256 values are 16 whole
    16-channel word groups (bitpack.unpack_14bit_torch)."""
    flat = unpack_14bit_torch(words, STREAM_N_CHANNELS * STREAM_N_SAMPLES,
                              ADC_BITS)
    return flat.reshape(*flat.shape[:-1], STREAM_N_SAMPLES, STREAM_N_CHANNELS)


# ---- superchunks + adapter duck interface --------------------------------------

def superchunk_frames(superchunks: np.ndarray, stream: bool = False) -> np.ndarray:
    fs = STREAM_FRAME_SIZE if stream else FRAME_SIZE
    n = STREAM_FRAMES_PER_SUPERCHUNK if stream else FRAMES_PER_SUPERCHUNK
    return superchunks.reshape(*superchunks.shape[:-1], n, fs)


def empty_superchunks(n: int = 1, stream: bool = False) -> np.ndarray:
    size = STREAM_SUPERCHUNK_SIZE if stream else SUPERCHUNK_SIZE
    return np.zeros((n, size), dtype=np.uint8)


def fake_timestamps(superchunks: np.ndarray, first_timestamp: int,
                    offset: int = EXPECTED_TICK_DIFFERENCE,
                    stream: bool = False) -> None:
    """Per-frame timestamps at +offset (DAPHNESuperChunkTypeAdapter.hpp:
    49-57), advancing ACROSS superchunks in a batch like the other
    adapters' batch semantics (wib2/protowib) — a multi-chunk batch gets
    globally monotonic timestamps, not a per-chunk restart."""
    frames = superchunk_frames(superchunks, stream=stream)
    setter = stream_set_timestamp if stream else set_timestamp
    n_frames = frames.shape[-2]
    flat = frames.reshape(-1, frames.shape[-1])
    ts = np.uint64(first_timestamp) + \
        np.arange(flat.shape[0], dtype=np.uint64) * np.uint64(offset)
    setter(flat, ts)


def get_first_timestamp(superchunks: np.ndarray, stream: bool = False):
    frames = superchunk_frames(superchunks, stream=stream)
    getter = stream_get_timestamp if stream else get_timestamp
    return getter(frames[..., 0, :])
