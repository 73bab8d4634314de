"""WIBEth frame format (DUNE FD horizontal-drift Ethernet readout).

Port copy of ``fdreadoutlibs_tpu/formats/wibeth.py``: the same code apart
from imports, with the torch device unpack :func:`unpack_frames` in place
of the jnp ``unpack_frames_jnp`` (:155-164). It is carried here because
importing the original pulls in jax through its package's ``__init__``.
The words14 feed layout (:func:`unpack_words14`, :func:`words14_positions`,
:func:`words14_channel_of_position`) comes from
``fdreadoutlibs_tpu/ops/pallas_tpg.py``, which imports jax.

Geometry (reference: include/fdreadoutlibs/DUNEWIBEthTypeAdapter.hpp:18-99 and
fddetdataformats WIBEthFrame as exercised by wibeth/tpg/FrameExpand.hpp:192-246):

* one frame = 7200 bytes = 4 x 64-bit header words + adc_words[64][14]
  (64 time samples x 14 uint64 words; each row packs 64 channels x 14-bit
  ADCs little-endian, 896 bits);
* header word 0 = DAQEthHeader bitfields
  (version:6, det_id:6, crate_id:10, slot_id:4, stream_id:8, reserved:6,
  seq_id:12, block_length:12), word 1 = 64-bit timestamp, words 2-3 = WIB
  colddata header (opaque here);
* adapter traits: fixed_payload_size=7200, expected_tick_difference=2048,
  samples_per_frame=64, samples_tick_difference=32
  (DUNEWIBEthTypeAdapter.hpp:90-95).

The reference's AVX2 expansion emits channels in "register order": register r
lane j holds frame channel ``16*r + PERMUTATION[j]`` with
PERMUTATION = {0..7, 15, 8..14} (unittest/WIBEthFrameExpansion_test.cxx:111).
Our TPU unpack produces natural frame-channel order (the permutation is an
AVX artifact); :func:`to_register_order` reproduces the reference layout
exactly for parity checks.
"""

from __future__ import annotations

import numpy as np

import torch

from .bitpack import pack_14bit, unpack_14bit, unpack_14bit_torch

# ---- geometry / adapter traits -------------------------------------------------
FRAME_SIZE = 7200                  # bytes
N_CHANNELS = 64                    # s_channels_per_half_femb
N_TIME_SAMPLES = 64                # s_time_samples_per_frame (= FRAMES_PER_MSG)
ADC_WORDS_PER_TS = 14              # s_num_adc_words_per_ts (uint64 words)
HEADER_WORDS = 4                   # DAQEthHeader (2) + WIB header (2)
ADC_BITS = 14
EXPECTED_TICK_DIFFERENCE = 2048    # ticks between consecutive frames
SAMPLES_PER_FRAME = 64
SAMPLES_TICK_DIFFERENCE = 32       # clocks per TPC tick (62.5 MHz / 32)
FRAGMENT_TYPE = "kWIBEth"
SUBSYSTEM = "kDetectorReadout"

# In-register channel permutation of the reference AVX2 unpack
# (WIBEthFrameExpansion_test.cxx:111; iota in wibeth/tpg/ProcessAVX2.hpp:32).
PERMUTATION = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 8, 9, 10, 11, 12, 13, 14])

# DAQEthHeader word-0 bitfields: name -> (lsb, width)
DAQ_HEADER_FIELDS = {
    "version": (0, 6),
    "det_id": (6, 6),
    "crate_id": (12, 10),
    "slot_id": (22, 4),
    "stream_id": (26, 8),
    "reserved": (34, 6),
    "seq_id": (40, 12),
    "block_length": (52, 12),
}


# ---- frame construction / header access (numpy, host side) --------------------

def empty_frames(n: int = 1) -> np.ndarray:
    """Allocate `n` zeroed WIBEth frames as a (n, 7200) uint8 array."""
    return np.zeros((n, FRAME_SIZE), dtype=np.uint8)


def _words(frames: np.ndarray) -> np.ndarray:
    """View (..., 7200) uint8 frames as (..., 900) little-endian uint64 words."""
    assert frames.dtype == np.uint8 and frames.shape[-1] == FRAME_SIZE
    return frames.view("<u8")


def get_timestamp(frames: np.ndarray) -> np.ndarray:
    return _words(frames)[..., 1].copy()


def set_timestamp(frames: np.ndarray, ts) -> None:
    _words(frames)[..., 1] = np.asarray(ts, dtype=np.uint64)


def get_header_field(frames: np.ndarray, name: str) -> np.ndarray:
    lsb, width = DAQ_HEADER_FIELDS[name]
    w0 = _words(frames)[..., 0]
    return ((w0 >> np.uint64(lsb)) & np.uint64((1 << width) - 1)).astype(np.int64)


def set_header_field(frames: np.ndarray, name: str, value) -> None:
    lsb, width = DAQ_HEADER_FIELDS[name]
    words = _words(frames)
    mask = np.uint64(((1 << width) - 1) << lsb)
    v = (np.asarray(value, dtype=np.uint64) << np.uint64(lsb)) & mask
    words[..., 0] = (words[..., 0] & ~mask) | v


def adc_region_u32(frames: np.ndarray) -> np.ndarray:
    """View the ADC region as (..., 64, 28) little-endian uint32 words."""
    u32 = frames.view("<u4")  # (..., 1800)
    return u32[..., HEADER_WORDS * 2:].reshape(*frames.shape[:-1], N_TIME_SAMPLES,
                                               ADC_WORDS_PER_TS * 2)


def get_adcs(frames: np.ndarray) -> np.ndarray:
    """Unpack all ADCs -> (..., 64 time, 64 channel) uint16 (frame order)."""
    return unpack_14bit(adc_region_u32(frames), N_CHANNELS, ADC_BITS)


def set_adcs(frames: np.ndarray, adcs: np.ndarray) -> None:
    """Pack (..., 64 time, 64 channel) ADC values into the frames in place."""
    packed = pack_14bit(adcs, ADC_BITS, n_words=ADC_WORDS_PER_TS * 2)
    adc_region_u32(frames)[...] = packed


def get_adc(frames: np.ndarray, channel: int, sample: int) -> np.ndarray:
    """Single (channel, time) accessor, mirroring WIBEthFrame::get_adc."""
    return get_adcs(frames)[..., sample, channel]


def set_adc(frames: np.ndarray, channel: int, sample: int, value) -> None:
    adcs = get_adcs(frames).copy()
    adcs[..., sample, channel] = value
    set_adcs(frames, adcs)


# ---- type-adapter duck interface (DUNEWIBEthTypeAdapter.hpp:36-95) ------------

def fake_timestamps(frames: np.ndarray, first_timestamp: int,
                    offset: int = EXPECTED_TICK_DIFFERENCE) -> None:
    """Set perfectly incrementing per-frame timestamps (emulator mode)."""
    n = frames.shape[0] if frames.ndim > 1 else 1
    ts = np.uint64(first_timestamp) + np.arange(n, dtype=np.uint64) * np.uint64(offset)
    set_timestamp(frames, ts.reshape(frames.shape[:-1]))


def fake_geoid(frames: np.ndarray, crate_id: int, slot_id: int, stream_id: int) -> None:
    set_header_field(frames, "crate_id", crate_id)
    set_header_field(frames, "slot_id", slot_id)
    set_header_field(frames, "stream_id", stream_id)


def fake_adc_pattern(frames: np.ndarray, channel: int) -> None:
    """Set `channel` of the first time sample to the 14-bit max (16383)."""
    set_adc(frames, channel, 0, 16383)


def fake_seq_ids(frames: np.ndarray, first_seq_id: int = 0) -> None:
    n = frames.shape[0] if frames.ndim > 1 else 1
    seq = (np.uint64(first_seq_id) + np.arange(n, dtype=np.uint64)) & np.uint64(0xFFF)
    set_header_field(frames, "seq_id", seq.reshape(frames.shape[:-1]))


# ---- device-side unpack (ingest path) -----------------------------------------

def unpack_frames(words: torch.Tensor) -> torch.Tensor:
    """Device unpack: (..., T, 28) int32 ADC words -> (..., T, 64) int32
    ADCs in natural frame-channel order (expand_wibeth_adcs,
    FrameExpand.hpp:192-246, without the AVX register permutation)."""
    return unpack_14bit_torch(words, N_CHANNELS, ADC_BITS)


def unpack_words14(W: torch.Tensor, n_channels: int) -> torch.Tensor:
    """Device unpack of the words14 feed: (T, WR, 7, 128) int32 word rows
    (``native.relayout_words14``: word j of 7-word channel group g at row
    g // 128, lane g % 128) -> (T, n_channels) int32 ADCs in canonical
    channel order — ``pallas_tpg._unpack14_rows`` (:241-265) followed by
    the gather through :func:`words14_positions`."""
    T, WR, seven, lanes = W.shape
    if seven != 7 or lanes != 128:
        raise ValueError(f"expected words14 rows (T, WR, 7, 128), got "
                         f"{tuple(W.shape)}")
    G = n_channels // 16
    words = W.transpose(2, 3).reshape(T, WR * lanes, 7)[:, :G]
    return unpack_14bit_torch(words.reshape(T, G * 7), n_channels, ADC_BITS)


def unpack_words14_gather(W: torch.Tensor, n_channels: int) -> torch.Tensor:
    """The gather formulation of :func:`unpack_words14`
    (``pallas_tpg._unpack14_rows_gather``, :268-305): each class r's low
    word j_r and high word j_r + 1 (a zero row where the sample fits one
    word) gathered into output-row order, then one shift/or/mask chain
    with per-row shifts sh_r = 14r mod 32.  The logical right shift comes
    from masking the words to 32 bits in int64.  Bit-equal to
    :func:`unpack_words14`; (T, WR, 7, 128) -> (T, n_channels) int32."""
    T, WR, seven, lanes = W.shape
    if seven != 7 or lanes != 128:
        raise ValueError(f"expected words14 rows (T, WR, 7, 128), got "
                         f"{tuple(W.shape)}")
    w = W.to(torch.int64) & 0xFFFFFFFF
    zero = torch.zeros_like(w[:, :, :1])
    lo, hi = [], []
    for r in range(16):
        j, sh = 14 * r // 32, 14 * r % 32
        lo.append(w[:, :, j:j + 1])
        hi.append(w[:, :, j + 1:j + 2] if sh + 14 > 32 else zero)
    sh = (14 * torch.arange(16, device=W.device).view(1, 1, 16, 1)) & 31
    v = ((torch.cat(lo, dim=2) >> sh) | (torch.cat(hi, dim=2) << ((32 - sh)
                                                                 & 31))) \
        & 0x3FFF                                     # (T, WR, 16, 128)
    pos = torch.from_numpy(words14_positions(n_channels)).to(W.device)
    return v.to(torch.int32).reshape(T, -1).index_select(1, pos)


def words14_positions(n_channels: int) -> np.ndarray:
    """Flat lane of each channel in the JAX fused kernels' words14 layout
    (copy of ``pallas_tpg.words14_positions``, :332-345): channel
    c = 16g + r at row (g // 128) * 16 + r, lane g % 128."""
    if n_channels % 16:
        raise ValueError(f"{n_channels} channels is not a whole number of "
                         "16-channel word groups")
    c = np.arange(n_channels)
    g, r = c // 16, c % 16
    return ((g // 128) * 16 + r) * 128 + (g % 128)


def words14_channel_of_position(n_channels: int) -> np.ndarray:
    """Inverse of :func:`words14_positions`: flat lane -> channel (-1 = a
    dead padding lane); copy of ``pallas_tpg.words14_channel_of_position``
    (:369-376)."""
    pos = words14_positions(n_channels)
    n_rows = 16 * (-(-(n_channels // 16) // 128))
    out = np.full(n_rows * 128, -1, dtype=np.int64)
    out[pos] = np.arange(n_channels)
    return out


# ---- host views (ingest path) -------------------------------------------------

def frames_bytes_to_u32(frames_u8: np.ndarray) -> np.ndarray:
    """Host helper: (..., 7200) uint8 -> (..., 64, 28) uint32 ADC words."""
    return np.ascontiguousarray(adc_region_u32(frames_u8))


# ---- reference-layout parity ---------------------------------------------------

def register_order_channels() -> np.ndarray:
    """Frame-channel index held by each reference register lane.

    Lane ``16*r + j`` of the reference MessageRegisters holds frame channel
    ``16*r + PERMUTATION[j]`` (WIBEthFrameExpansion_test.cxx:122-151).
    """
    regs = np.arange(N_CHANNELS) // 16
    lanes = np.arange(N_CHANNELS) % 16
    return regs * 16 + PERMUTATION[lanes]


def to_register_order(adcs: np.ndarray) -> np.ndarray:
    """Reorder (..., channel) frame-order ADCs into reference register order."""
    return adcs[..., register_order_channels()]


def from_register_order(adcs_reg: np.ndarray) -> np.ndarray:
    inv = np.argsort(register_order_channels())
    return adcs_reg[..., inv]
