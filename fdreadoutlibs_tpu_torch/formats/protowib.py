"""ProtoWIB (ProtoDUNE-SP WIB/FELIX) frame format — 12-bit nibble-shuffled.

Port copy of ``fdreadoutlibs_tpu/formats/protowib.py``: the same code, with
the torch device decode :func:`unpack_frames` in place of the jnp
``unpack_frames_jnp`` (:261-279).

Geometry (reference: include/fdreadoutlibs/ProtoWIBSuperChunkTypeAdapter.hpp,
wib/tpg/TPGConstants.hpp:17-46, wib/tpg/FrameExpand.hpp:151-235):

* one frame = 464 bytes = WIB header (4 x 32-bit words) + 4 COLDATA blocks;
* a COLDATA block = 112 bytes = block header (4 words) + 8 segments x 12
  bytes; a segment carries 2 ADC chips x 4 channels of 12-bit values in the
  FEMB nibble-shuffled order (decoded below — the layout is exactly what
  the AVX2 ``expand_two_segments`` shuffle network implements,
  FrameExpand.hpp:151-235):

    byte 0:  a0c0[7:0]          byte 1:  a1c0[7:0]
    byte 2:  a0c0[11:8] | a0c1[3:0] << 4
    byte 3:  a1c0[11:8] | a1c1[3:0] << 4
    byte 4:  a0c1[11:4]         byte 5:  a1c1[11:4]
    bytes 6-11: same pattern for c2/c3

* frame channel order: block*64 + segment*8 + adc*4 + ch (256 channels);
* a superchunk = 12 frames = 5568 bytes; expected_tick_difference = 25
  ("2 MHz @ 50 MHz clock", ProtoWIBSuperChunkTypeAdapter.hpp:100);
* the register layout splits channels into 6 collection + 10 induction
  registers; the in-frame channel numbers and offline offsets of each
  register position are the tables in src/wib/tpg/FrameExpand.cpp:205-299
  (ported below as data).

Timestamp: the real fddetdataformats WIBHeader layout — ts[31:0] in header
word 2, ts[47:32] in word 3 bits [15:0], and ts[62:48] in the wib_counter_1
field (word 3 bits [30:16]) gated on the z bit (bit 31): z=0 means the
counter field extends the timestamp, z=1 means it is an independent WIB
counter and the timestamp is 48-bit.  See get_timestamp/set_timestamp and
the byte-position round-trip test (tests/test_formats_all.py).
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_SIZE = 464
N_CHANNELS = 256
N_BLOCKS = 4
SEGMENTS_PER_BLOCK = 8
CHANNELS_PER_SEGMENT = 8
BLOCK_HEADER_BYTES = 16
SEGMENT_BYTES = 12
BLOCK_BYTES = BLOCK_HEADER_BYTES + SEGMENTS_PER_BLOCK * SEGMENT_BYTES  # 112
HEADER_BYTES = 16
FRAMES_PER_SUPERCHUNK = 12
SUPERCHUNK_SIZE = FRAME_SIZE * FRAMES_PER_SUPERCHUNK       # 5568
EXPECTED_TICK_DIFFERENCE = 25
SUPERCHUNK_TICK_DIFFERENCE = EXPECTED_TICK_DIFFERENCE * FRAMES_PER_SUPERCHUNK
ADC_BITS = 12
N_COLLECTION = 96                   # 6 registers x 16
N_INDUCTION = 160                   # 10 registers x 16
FRAGMENT_TYPE = "kProtoWIB"

# Register-position -> in-frame channel / offline offset tables, ported from
# src/wib/tpg/FrameExpand.cpp:205-299 ("lightly-edited output of
# number_collection_and_induction").
COLLECTION_INDEX_TO_CHAN = np.array([
    16, 17, 18, 19, 10, 11, 20, 21, 12, 13, 14, 15, 208, 209,
    210, 211, 48, 49, 50, 51, 42, 43, 52, 53, 44, 45, 46, 47,
    202, 203, 212, 213, 80, 81, 82, 83, 74, 75, 84, 85, 76, 77,
    78, 79, 204, 205, 206, 207, 112, 113, 114, 115, 106, 107, 116, 117,
    108, 109, 110, 111, 240, 241, 242, 243, 144, 145, 146, 147, 138, 139,
    148, 149, 140, 141, 142, 143, 234, 235, 244, 245, 176, 177, 178, 179,
    170, 171, 180, 181, 172, 173, 174, 175, 236, 237, 238, 239])

COLLECTION_OFFLINES = np.array([
    12, 14, 16, 18, 23, 21, 20, 22, 19, 17, 15, 13, 264, 266, 268, 270,
    0, 2, 4, 6, 11, 9, 8, 10, 7, 5, 3, 1, 275, 273, 272, 274,
    24, 26, 28, 30, 35, 33, 32, 34, 31, 29, 27, 25, 271, 269, 267, 265,
    36, 38, 40, 42, 47, 45, 44, 46, 43, 41, 39, 37, 276, 278, 280, 282,
    252, 254, 256, 258, 263, 261, 260, 262, 259, 257, 255, 253, 287, 285, 284, 286,
    240, 242, 244, 246, 251, 249, 248, 250, 247, 245, 243, 241, 283, 281, 279, 277])

INDUCTION_INDEX_TO_CHAN = np.array([
    0, 1, 2, 3, 8, 9, 26, 27, 4, 5, 22, 23, 28, 29, 30, 31, 32, 33, 34, 35,
    40, 41, 58, 59, 36, 37, 54, 55, 60, 61, 62, 63, 64, 65, 66, 67, 72, 73,
    90, 91, 68, 69, 86, 87, 92, 93, 94, 95, 96, 97, 98, 99, 104, 105, 122,
    123, 100, 101, 118, 119, 124, 125, 126, 127, 128, 129, 130, 131, 136,
    137, 154, 155, 132, 133, 150, 151, 156, 157, 158, 159, 160, 161, 162,
    163, 168, 169, 186, 187, 164, 165, 182, 183, 188, 189, 190, 191, 192,
    193, 194, 195, 200, 201, 218, 219, 196, 197, 214, 215, 220, 221, 222,
    223, 224, 225, 226, 227, 232, 233, 250, 251, 228, 229, 246, 247, 252,
    253, 254, 255, 6, 7, 38, 39, 24, 25, 56, 57, 70, 71, 102, 103, 88, 89,
    120, 121, 134, 135, 166, 167, 152, 153, 184, 185, 198, 199, 230, 231,
    216, 217, 248, 249])

INDUCTION_OFFLINES = np.array([
    974, 976, 978, 229, 973, 971, 224, 226, 227, 225, 970, 972, 228, 979,
    977, 975, 964, 966, 968, 239, 963, 961, 234, 236, 237, 235, 960, 962,
    238, 969, 967, 965, 984, 986, 988, 219, 983, 981, 214, 216, 217, 215,
    980, 982, 218, 989, 987, 985, 994, 996, 998, 209, 993, 991, 204, 206,
    207, 205, 990, 992, 208, 999, 997, 995, 1174, 1176, 1178, 29, 1173,
    1171, 24, 26, 27, 25, 1170, 1172, 28, 1179, 1177, 1175, 1164, 1166,
    1168, 39, 1163, 1161, 34, 36, 37, 35, 1160, 1162, 38, 1169, 1167, 1165,
    1184, 1186, 1188, 19, 1183, 1181, 14, 16, 17, 15, 1180, 1182, 18, 1189,
    1187, 1185, 1194, 1196, 1198, 9, 1193, 1191, 4, 6, 7, 5, 1190, 1192, 8,
    1199, 1197, 1195, 223, 221, 233, 231, 220, 222, 230, 232, 213, 211,
    203, 201, 210, 212, 200, 202, 23, 21, 33, 31, 20, 22, 30, 32, 13, 11,
    3, 1, 10, 12, 0, 2])

# Plane membership by in-frame channel (the collection/induction split the
# ProtoWIB kernels run on separate registers/threads, WIBFrameProcessor.hpp)
COLLECTION_CHANNEL_MASK = np.zeros(N_CHANNELS, dtype=bool)
COLLECTION_CHANNEL_MASK[COLLECTION_INDEX_TO_CHAN] = True


def empty_frames(n: int = 1) -> np.ndarray:
    return np.zeros((n, FRAME_SIZE), dtype=np.uint8)


def empty_superchunks(n: int = 1) -> np.ndarray:
    return np.zeros((n, SUPERCHUNK_SIZE), dtype=np.uint8)


def superchunk_frames(superchunks: np.ndarray) -> np.ndarray:
    return superchunks.reshape(*superchunks.shape[:-1],
                               FRAMES_PER_SUPERCHUNK, FRAME_SIZE)


def _words(frames: np.ndarray) -> np.ndarray:
    assert frames.shape[-1] == FRAME_SIZE
    return frames.view("<u4")


# WIBHeader bit layout (fddetdataformats WIBFrame.hpp, the struct behind
# the get_wib_header()/get_timestamp() calls in
# WIBFrameProcessor.hpp:352-394 and the fake_* adapter methods):
#   word 0: sof:8 | version:5 | fiber_no:3 | crate_no:5 | slot_no:3 | rsvd:8
#   word 1: mm:1 | oos:1 | rsvd:14 | wib_errors:16
#   word 2: timestamp_1 (timestamp bits [31:0])
#   word 3: timestamp_2:16 (bits [47:32]) | wib_counter_1:15 | z:1
# get_timestamp() ORs wib_counter_1 in as bits [62:48] only when z == 0;
# set_timestamp() writes wib_counter_1 only when z == 0 (z set means the
# counter word carries an independent WIB counter, not timestamp bits).

def get_timestamp(frames: np.ndarray) -> np.ndarray:
    w = _words(frames)
    w3 = w[..., 3].astype(np.uint64)
    ts = w[..., 2].astype(np.uint64) | \
        ((w3 & np.uint64(0xFFFF)) << np.uint64(32))
    z = (w3 >> np.uint64(31)) & np.uint64(1)
    counter = (w3 >> np.uint64(16)) & np.uint64(0x7FFF)
    return ts | np.where(z == 0, counter << np.uint64(48), np.uint64(0))


def set_timestamp(frames: np.ndarray, ts) -> None:
    w = _words(frames)
    ts = np.asarray(ts, dtype=np.uint64)
    w[..., 2] = (ts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ts2 = ((ts >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.uint32)
    counter = ((ts >> np.uint64(48)) & np.uint64(0x7FFF)).astype(np.uint32)
    old = w[..., 3]
    z = old & np.uint32(0x80000000)
    # z=0: counter field carries ts bits [62:48]; z=1: leave it untouched
    keep = np.where(z != 0, old & np.uint32(0x7FFF0000), counter << 16)
    w[..., 3] = z | keep.astype(np.uint32) | ts2


def get_geo(frames: np.ndarray) -> dict:
    """crate/slot/fiber from header word 0 (WIBHeader bitfields)."""
    w0 = _words(frames)[..., 0]
    return {"fiber": (w0 >> 13) & 0x7, "crate": (w0 >> 16) & 0x1F,
            "slot": (w0 >> 21) & 0x7}


def set_geo(frames: np.ndarray, crate: int = 0, slot: int = 0,
            fiber: int = 0) -> None:
    """fake_geoid (ProtoWIBSuperChunkTypeAdapter.hpp fake_geoid)."""
    w = _words(frames)
    w[..., 0] = (w[..., 0] & np.uint32(0xFF001FFF)) | \
        np.uint32(((fiber & 0x7) << 13) | ((crate & 0x1F) << 16)
                  | ((slot & 0x7) << 21))


def set_wib_errors(frames: np.ndarray, errors: int) -> None:
    """16-bit wib_errors field in header word 1 bits [16:32]
    (fake_frame_errors, ProtoWIBSuperChunkTypeAdapter.hpp:72-79)."""
    w = _words(frames)
    w[..., 1] = (w[..., 1] & np.uint32(0x0000FFFF)) | \
        (np.uint32(errors & 0xFFFF) << np.uint32(16))


def get_wib_errors(frames: np.ndarray) -> np.ndarray:
    return (_words(frames)[..., 1] >> np.uint32(16)).astype(np.int64)


# ---- the 12-bit nibble-shuffled codec ------------------------------------------

def _segment_regions(frames: np.ndarray) -> np.ndarray:
    """(..., 464) -> (..., 4 blocks, 8 segments, 12 bytes)."""
    body = frames[..., HEADER_BYTES:].reshape(
        *frames.shape[:-1], N_BLOCKS, BLOCK_BYTES)
    return body[..., BLOCK_HEADER_BYTES:].reshape(
        *frames.shape[:-1], N_BLOCKS, SEGMENTS_PER_BLOCK, SEGMENT_BYTES)


def get_adcs(frames: np.ndarray) -> np.ndarray:
    """Decode all 256 channels -> (..., 256) uint16, frame channel order
    (block*64 + segment*8 + adc*4 + ch)."""
    seg = _segment_regions(frames).astype(np.uint16)
    out = np.zeros(frames.shape[:-1] + (N_BLOCKS, SEGMENTS_PER_BLOCK, 2, 4),
                   dtype=np.uint16)
    for adc in range(2):
        for grp in range(2):           # c0/c1 vs c2/c3 group
            b0 = seg[..., grp * 6 + adc]            # low byte of c0/c2
            b2 = seg[..., grp * 6 + 2 + adc]        # packed nibbles
            b4 = seg[..., grp * 6 + 4 + adc]        # high byte of c1/c3
            out[..., adc, grp * 2 + 0] = b0 | ((b2 & 0x0F) << 8)   # c0 / c2
            out[..., adc, grp * 2 + 1] = (b2 >> 4) | (b4 << 4)     # c1 / c3
    return out.reshape(*frames.shape[:-1], N_CHANNELS)


def set_adcs(frames: np.ndarray, adcs: np.ndarray) -> None:
    """Encode (..., 256) values (<=12 bits) into the frames in place."""
    vals = np.asarray(adcs, dtype=np.uint16).reshape(
        *frames.shape[:-1], N_BLOCKS, SEGMENTS_PER_BLOCK, 2, 4) & 0x0FFF
    seg = _segment_regions(frames)
    for adc in range(2):
        for grp in range(2):
            c_lo = vals[..., adc, grp * 2 + 0]
            c_hi = vals[..., adc, grp * 2 + 1]
            seg[..., grp * 6 + adc] = (c_lo & 0xFF).astype(np.uint8)
            seg[..., grp * 6 + 2 + adc] = ((c_lo >> 8) |
                                           ((c_hi & 0x0F) << 4)).astype(np.uint8)
            seg[..., grp * 6 + 4 + adc] = (c_hi >> 4).astype(np.uint8)


def get_adc(frames: np.ndarray, channel: int) -> np.ndarray:
    return get_adcs(frames)[..., channel]


N_FRAME_WORDS = FRAME_SIZE // 4                     # 116 uint32 words


def frames_bytes_to_u32(frames_u8: np.ndarray) -> np.ndarray:
    """Host helper: (..., 464) uint8 -> (..., 116) uint32 whole-frame words
    (a view-level reshape; the device codec extracts the ADC bytes)."""
    return np.ascontiguousarray(frames_u8).view("<u4")


def _channel_byte_offsets():
    """Per-channel absolute frame byte offsets of the 12-bit codec: channel
    c reads (lo_byte, nibble_byte) for even in-pair position or
    (nibble_byte, hi_byte) for odd (get_adcs above / the AVX expand
    networks, src/wib/tpg/FrameExpand.cpp)."""
    offs = []
    for c in range(N_CHANNELS):
        block, rest = divmod(c, 64)
        segment, rest = divmod(rest, 8)
        adc, ch = divmod(rest, 4)
        grp, pos = divmod(ch, 2)
        base = (HEADER_BYTES + block * BLOCK_BYTES + BLOCK_HEADER_BYTES
                + segment * SEGMENT_BYTES + grp * 6 + adc)
        offs.append((base, base + 2, base + 4, pos))
    return offs


def _decode_index():
    """(lo, hi, shift_lo, shift_hi, mask_lo) per channel: channel c is
    (byte[lo] >> shift_lo & mask_lo) | (byte[hi] << shift_hi) & 0xFFF —
    the low byte and the low nibble (even position) or the high nibble
    and the high byte (odd position) of :func:`_channel_byte_offsets`."""
    lo, hi, sl, sh, ml = [], [], [], [], []
    for b0, b2, b4, pos in _channel_byte_offsets():
        if pos == 0:
            lo.append(b0), hi.append(b2), sl.append(0), sh.append(8)
            ml.append(0xFF)
        else:
            lo.append(b2), hi.append(b4), sl.append(4), sh.append(4)
            ml.append(0x0F)
    return tuple(np.asarray(a) for a in (lo, hi, sl, sh, ml))


_DECODE = _decode_index()


def unpack_frames(words: torch.Tensor) -> torch.Tensor:
    """Device decode: (..., 116) int32 whole-frame words -> (..., 256)
    int32 ADCs in frame channel order.  A gather of two bytes per channel
    and static shifts and masks, on any device (the counterpart of
    ``unpack_frames_jnp``)."""
    dev = words.device
    b = words.contiguous().view(torch.uint8).to(torch.int32)   # (..., 464)
    lo, hi, sl, sh, ml = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                          for a in _DECODE)
    v_lo = (b.index_select(-1, lo.long()) >> sl) & ml
    v_hi = b.index_select(-1, hi.long()) << sh
    return (v_lo | v_hi) & 0xFFF


# ---- adapter duck interface ----------------------------------------------------

def fake_timestamps(superchunks: np.ndarray, first_timestamp: int,
                    offset: int = EXPECTED_TICK_DIFFERENCE) -> None:
    frames = superchunk_frames(superchunks)
    n = frames.shape[0] if frames.ndim == 3 else 1
    idx = np.arange(n * FRAMES_PER_SUPERCHUNK, dtype=np.uint64)
    set_timestamp(frames.reshape(-1, FRAME_SIZE),
                  np.uint64(first_timestamp) + idx * np.uint64(offset))


def fake_frame_errors(superchunks: np.ndarray, errors) -> None:
    """Set per-frame wib_errors (ProtoWIBSuperChunkTypeAdapter.hpp:72-79)."""
    frames = superchunk_frames(superchunks).reshape(-1, FRAME_SIZE)
    errs = np.broadcast_to(np.asarray(errors), (frames.shape[0],))
    for i, e in enumerate(errs):
        set_wib_errors(frames[i:i + 1], int(e))


# ---- register-layout parity ----------------------------------------------------

def to_register_order(adcs: np.ndarray):
    """(..., 256) frame-order ADCs -> (collection (..., 96),
    induction (..., 160)) in the reference register layout."""
    return (adcs[..., COLLECTION_INDEX_TO_CHAN],
            adcs[..., INDUCTION_INDEX_TO_CHAN])


def register_offline_channels(min_collection_offline: int = 9472,
                              min_induction_offline: int = 7680):
    """Offline channel per register position (FrameExpand.cpp comments:
    collection min 9472, induction min 7680 for the reference APA)."""
    return (COLLECTION_OFFLINES + min_collection_offline,
            INDUCTION_OFFLINES + min_induction_offline)
