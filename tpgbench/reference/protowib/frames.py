"""ProtoWIB frames in the plain reference: the layout, the 12-bit codec,
the header fields and the register maps.

A frame is 464 bytes: a 16-byte WIB header (four 32-bit words), then four
COLDATA blocks of 112 bytes, each a 16-byte block header and eight 12-byte
segments.  A segment holds 8 channels (2 ADC chips x 4) of 12 bits,
interleaved by chip; for chip a (0 or 1) and pair g (0: channels 0-1,
1: channels 2-3) its bytes are

    byte 6g + a      the even channel's bits 0-7
    byte 6g + 2 + a  the even channel's bits 8-11 (low nibble) and the odd
                     channel's bits 0-3 (high nibble)
    byte 6g + 4 + a  the odd channel's bits 4-11

and the frame's channel is block * 64 + segment * 8 + a * 4 + 2g + (0|1).
Header word 1 carries the 16 WIB error bits in its upper half; words 2 and
3 the timestamp: bits 0-31, bits 32-47 in word 3's low half, and bits
48-62 in word 3's bits 16-30 when bit 31 (z) is clear.  A superchunk is 12
frames; a frame is one tick of 25 clocks of the 50 MHz timing clock.
"""

from __future__ import annotations

import torch

FRAME_BYTES = 464
HEADER_BYTES = 16
BLOCKS = 4
BLOCK_BYTES = 112
BLOCK_HEADER_BYTES = 16
SEGMENTS = 8
SEGMENT_BYTES = 12
CHANNELS = 256
FRAMES_PER_SUPERCHUNK = 12
SUPERCHUNK_BYTES = FRAME_BYTES * FRAMES_PER_SUPERCHUNK
CLOCKS_PER_TICK = 25
CLOCK_HZ = 50e6
ADC_BITS = 12

# register position -> frame channel and its offline offset, collection
# (6 registers of 16) and induction (10 of 16): the tables of upstream
# src/wib/tpg/FrameExpand.cpp:205-299
COLLECTION_INDEX_TO_CHAN = (
    16, 17, 18, 19, 10, 11, 20, 21, 12, 13, 14, 15, 208, 209, 210, 211, 48,
    49, 50, 51, 42, 43, 52, 53, 44, 45, 46, 47, 202, 203, 212, 213, 80, 81,
    82, 83, 74, 75, 84, 85, 76, 77, 78, 79, 204, 205, 206, 207, 112, 113,
    114, 115, 106, 107, 116, 117, 108, 109, 110, 111, 240, 241, 242, 243,
    144, 145, 146, 147, 138, 139, 148, 149, 140, 141, 142, 143, 234, 235,
    244, 245, 176, 177, 178, 179, 170, 171, 180, 181, 172, 173, 174, 175,
    236, 237, 238, 239)
COLLECTION_OFFLINES = (
    12, 14, 16, 18, 23, 21, 20, 22, 19, 17, 15, 13, 264, 266, 268, 270, 0,
    2, 4, 6, 11, 9, 8, 10, 7, 5, 3, 1, 275, 273, 272, 274, 24, 26, 28, 30,
    35, 33, 32, 34, 31, 29, 27, 25, 271, 269, 267, 265, 36, 38, 40, 42, 47,
    45, 44, 46, 43, 41, 39, 37, 276, 278, 280, 282, 252, 254, 256, 258,
    263, 261, 260, 262, 259, 257, 255, 253, 287, 285, 284, 286, 240, 242,
    244, 246, 251, 249, 248, 250, 247, 245, 243, 241, 283, 281, 279, 277,)

INDUCTION_INDEX_TO_CHAN = (
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
    216, 217, 248, 249,)

INDUCTION_OFFLINES = (
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
    3, 1, 10, 12, 0, 2,)

N_COLLECTION = len(COLLECTION_INDEX_TO_CHAN)
N_INDUCTION = len(INDUCTION_INDEX_TO_CHAN)


def decode(frames: torch.Tensor) -> torch.Tensor:
    """(..., 464) uint8 frames -> (..., 256) int32 samples in frame channel
    order."""
    if frames.shape[-1] != FRAME_BYTES:
        raise ValueError(f"frames of {frames.shape[-1]} bytes, expected "
                         f"{FRAME_BYTES}")
    lead = frames.shape[:-1]
    body = frames[..., HEADER_BYTES:].reshape(*lead, BLOCKS, BLOCK_BYTES)
    seg = body[..., BLOCK_HEADER_BYTES:].reshape(
        *lead, BLOCKS, SEGMENTS, SEGMENT_BYTES).to(torch.int32)
    out = torch.empty((*lead, BLOCKS, SEGMENTS, 2, 4), dtype=torch.int32)
    for a in range(2):
        for g in range(2):
            low, mid, high = (seg[..., 6 * g + a], seg[..., 6 * g + 2 + a],
                              seg[..., 6 * g + 4 + a])
            out[..., a, 2 * g] = low | ((mid & 0xF) << 8)
            out[..., a, 2 * g + 1] = (mid >> 4) | (high << 4)
    return out.reshape(*lead, CHANNELS)


def _words(frames: torch.Tensor, i: int) -> torch.Tensor:
    """Header word ``i`` of each frame, as int64 (little-endian)."""
    b = frames[..., 4 * i:4 * i + 4].to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def timestamps(frames: torch.Tensor) -> torch.Tensor:
    """(..., 464) frames -> (...,) int64 timestamps."""
    w3 = _words(frames, 3)
    ts = _words(frames, 2) | ((w3 & 0xFFFF) << 32)
    extend = ((w3 >> 31) & 1) == 0
    return ts | torch.where(extend, ((w3 >> 16) & 0x7FFF) << 48, 0)


def wib_errors(frames: torch.Tensor) -> torch.Tensor:
    """(..., 464) frames -> (...,) int64 16-bit WIB error fields."""
    return _words(frames, 1) >> 16


def register_channels() -> torch.Tensor:
    """(256,) int64: a link's frame channels in register order, the 96
    collection positions then the 160 induction ones."""
    return torch.tensor(COLLECTION_INDEX_TO_CHAN + INDUCTION_INDEX_TO_CHAN,
                        dtype=torch.int64)


def offline_channels(min_collection: int, min_induction: int):
    """(collection (96,), induction (160,)) int64 offline channels of the
    register positions, from the APA's lowest offline channel of each."""
    return (torch.tensor(COLLECTION_OFFLINES, dtype=torch.int64)
            + min_collection,
            torch.tensor(INDUCTION_OFFLINES, dtype=torch.int64)
            + min_induction)
