"""Bit-packing codecs for densely packed little-endian ADC words.

Port copy of ``fdreadoutlibs_tpu/formats/bitpack.py``: the same code apart
from imports, without the jnp device unpack ``unpack_14bit_jnp``. It is
carried here because importing the original pulls in jax through its
package's ``__init__``.

The WIB frame families pack N-bit ADCs back-to-back, little-endian, into
64-bit words: channel ``c`` occupies bits ``[N*c, N*(c+1))`` of the ADC
region.  The reference unpacks these with an AVX2 permute/shift/or ladder
(``unpack_one_register``, the reference's
include/fdreadoutlibs/wibeth/tpg/FrameExpand.hpp:84-186).  On TPU we
express the same transform as static strided slices + shifts over 32-bit words — XLA vectorizes it with no
gathers, and every shift amount is a compile-time constant.

Two implementations are provided:

* numpy (host side, uses uint64 intermediates) — used by frame writers,
  emulators and tests;
* jnp (device side, uint32-only, static shifts) — used in the ingest path
  before the Pallas TPG kernel.

Both are bit-exact against each other (round-trip tested).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_14bit", "unpack_14bit", "words_per_row"]


def words_per_row(n_channels: int, bits: int = 14, word_bits: int = 32) -> int:
    """Number of `word_bits` words holding `n_channels` packed ADCs."""
    total = n_channels * bits
    return -(-total // word_bits)


def unpack_14bit(words_u32: np.ndarray, n_channels: int, bits: int = 14) -> np.ndarray:
    """Unpack little-endian `bits`-bit ADCs from uint32 words (numpy).

    words_u32: (..., W) uint32 with W >= ceil(n_channels*bits/32).
    Returns (..., n_channels) uint16.
    """
    w = np.ascontiguousarray(words_u32).astype(np.uint64)
    # pad one zero word so the (w0 | w1<<32) pair never goes out of bounds
    pad = np.zeros(w.shape[:-1] + (1,), dtype=np.uint64)
    w = np.concatenate([w, pad], axis=-1)
    mask = np.uint64((1 << bits) - 1)
    out = np.empty(w.shape[:-1] + (n_channels,), dtype=np.uint16)
    for c in range(n_channels):
        bit = c * bits
        wi, sh = bit // 32, bit % 32
        pair = w[..., wi] | (w[..., wi + 1] << np.uint64(32))
        out[..., c] = ((pair >> np.uint64(sh)) & mask).astype(np.uint16)
    return out


def pack_14bit(adcs: np.ndarray, bits: int = 14, n_words: int | None = None) -> np.ndarray:
    """Pack (..., C) ADC values into little-endian uint32 words (numpy)."""
    adcs = np.asarray(adcs)
    C = adcs.shape[-1]
    W = n_words if n_words is not None else words_per_row(C, bits)
    vals = adcs.astype(np.uint64) & np.uint64((1 << bits) - 1)
    out = np.zeros(adcs.shape[:-1] + (W + 1,), dtype=np.uint64)
    for c in range(C):
        bit = c * bits
        wi, sh = bit // 32, bit % 32
        out[..., wi] |= (vals[..., c] << np.uint64(sh)) & np.uint64(0xFFFFFFFF)
        spill = vals[..., c] >> np.uint64(32 - sh) if sh else np.zeros_like(vals[..., c])
        if sh:
            out[..., wi + 1] |= spill
    return out[..., :W].astype(np.uint32)


def dump_registers(adcs, per_register: int = 16, fmt: str = "dec") -> str:
    """Debug printer for unpacked values in 16-lane register groups — the
    print256_as16 / print256_as16_dec equivalents (src/*/tpg/FrameExpand.cpp).
    """
    adcs = np.asarray(adcs).reshape(-1)
    lines = []
    for r in range(0, len(adcs), per_register):
        group = adcs[r:r + per_register]
        if fmt == "hex":
            body = " ".join(f"{int(v) & 0xFFFF:04x}" for v in group)
        else:
            body = " ".join(f"{int(v):6d}" for v in group)
        lines.append(f"reg {r // per_register:3d}: {body}")
    return "\n".join(lines)

