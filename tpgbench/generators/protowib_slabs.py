"""ProtoWIB superchunk slabs: a ring of pre-made batches per APA.

Each slab is ``frames_per_batch`` ProtoWIB frames (whole superchunks of
12) on each link: noise around a pedestal with Poisson-many pulses, made
in bulk on the device from the seed as ``wibeth_slabs`` makes WIBEth's,
saturating at the 12-bit limit, and packed into the frames' nibble codec
(``reference/protowib/frames.py`` states the layout) on the device.  The
header's WIB error bits are clear.  Reusing a slab rewrites only its
frames' timestamps, 25 clocks a frame and 300 a superchunk, continuous
over the whole stream; the processors keep no frame past their call, so
the ring needs only enough slabs that neighbouring batches differ.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.protowib.frames import (ADC_BITS, BLOCK_BYTES,
                                         BLOCK_HEADER_BYTES, BLOCKS,
                                         CHANNELS, CLOCKS_PER_TICK,
                                         FRAME_BYTES, FRAMES_PER_SUPERCHUNK,
                                         HEADER_BYTES, SEGMENT_BYTES,
                                         SEGMENTS, SUPERCHUNK_BYTES)
from .wibeth_slabs import seed_streams

TS0 = 0x1000000


def encode(adcs: torch.Tensor) -> torch.Tensor:
    """(L, N, 256) 12-bit samples in frame channel order -> (L, N, 464)
    uint8 frames with the samples packed and the headers zero."""
    L, N = adcs.shape[:2]
    v = adcs.to(torch.int32).reshape(L, N, BLOCKS, SEGMENTS, 2, 4)
    seg = torch.empty((L, N, BLOCKS, SEGMENTS, SEGMENT_BYTES),
                      dtype=torch.int32, device=adcs.device)
    for a in range(2):
        for g in range(2):
            even, odd = v[..., a, 2 * g], v[..., a, 2 * g + 1]
            seg[..., 6 * g + a] = even & 0xFF
            seg[..., 6 * g + 2 + a] = (even >> 8) | ((odd & 0xF) << 4)
            seg[..., 6 * g + 4 + a] = odd >> 4
    frames = torch.zeros((L, N, FRAME_BYTES), dtype=torch.uint8,
                         device=adcs.device)
    body = frames[..., HEADER_BYTES:].view(L, N, BLOCKS, BLOCK_BYTES)
    body[..., BLOCK_HEADER_BYTES:] = seg.reshape(
        L, N, BLOCKS, SEGMENTS * SEGMENT_BYTES).to(torch.uint8)
    return frames


def make_slab(gen: torch.Generator, traffic: dict, L: int, device):
    """One batch slab's samples, (L, N, 256) int32, from ``gen``."""
    N = int(traffic["frames_per_batch"])
    adcs = (traffic["pedestal"] + traffic["noise_sigma"] * torch.randn(
        (L, N, CHANNELS), generator=gen, device=device)).to(torch.int32)
    mean = traffic["pulse_rate_per_channel_tick"] * L * N * CHANNELS
    n = int(torch.poisson(torch.tensor([float(mean)], device=device),
                          generator=gen).item())
    if n:
        def draw(lo, hi):
            return torch.randint(lo, hi, (n,), generator=gen, device=device)
        link, chan = draw(0, L), draw(0, CHANNELS)
        t0 = draw(0, N - traffic["pulse_ticks"] + 1)
        amp = draw(*traffic["pulse_adc"]).to(torch.int32)
        for k in range(traffic["pulse_ticks"]):
            adcs.index_put_((link, t0 + k, chan), amp, accumulate=True)
    return torch.clamp(adcs, 0, (1 << ADC_BITS) - 1)


class Source:
    """Per APA a ring of ``ring`` slabs of ``links`` x ``frames_per_batch``
    ProtoWIB frames; :meth:`batch` hands out batch b of an APA's stream as
    (L, superchunks, 5568) uint8."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 n_apas: int, ring: int):
        self.L = int(config["links"])
        self.N = int(traffic["frames_per_batch"])
        if self.N % FRAMES_PER_SUPERCHUNK:
            raise ValueError(f"{self.N} frames a batch are no whole "
                             "superchunks")
        self.S = self.N // FRAMES_PER_SUPERCHUNK
        self.ring = int(ring)
        # header word 0: the link's fiber, crate and slot (WIBHeader
        # bitfields); word 1: the error bits, clear
        link = np.arange(self.L, dtype=np.uint32)
        w0 = ((link % 2) << 13) | (np.uint32(config["crate"]) << 16) \
            | ((link // 2) << 21)
        self.rings = []
        for apa_seed in seed_streams(seed, n_apas):
            gen = torch.Generator(device=device)
            gen.manual_seed(apa_seed)
            slabs = []
            for _ in range(self.ring):
                frames = encode(make_slab(gen, traffic, self.L, device))
                slab = np.empty((self.L, self.S, SUPERCHUNK_BYTES), np.uint8)
                slab.reshape(self.L, self.N, FRAME_BYTES)[...] = \
                    frames.cpu().numpy()
                self._words(slab)[..., 0] = w0[:, None]
                slabs.append(slab)
            self.rings.append(slabs)
        self._clocks = np.arange(self.N, dtype=np.uint64) \
            * np.uint64(CLOCKS_PER_TICK)

    def _words(self, slab: np.ndarray) -> np.ndarray:
        return slab.view("<u4").reshape(self.L, self.N, FRAME_BYTES // 4)

    def slab(self, apa: int, b: int) -> np.ndarray:
        """The (L, S, 5568) slab that carries batch ``b`` (its samples)."""
        return self.rings[apa][b % self.ring]

    def batch_ts(self, b: int) -> int:
        """Timestamp of the first frame of batch ``b`` on every link."""
        return TS0 + b * self.N * CLOCKS_PER_TICK

    def batch(self, apa: int, b: int) -> np.ndarray:
        """Batch ``b`` of APA ``apa``: its slab with every frame's
        timestamp rewritten for ``b``, continuous with batch b - 1.  With
        the z bit clear, header words 2 and 3 read as one little-endian
        64-bit word are the timestamp itself (bits 0-62)."""
        slab = self.slab(apa, b)
        stamps = slab.view("<u8").reshape(self.L, self.N, FRAME_BYTES // 8)
        stamps[..., 1] = np.uint64(self.batch_ts(b)) + self._clocks
        return slab
