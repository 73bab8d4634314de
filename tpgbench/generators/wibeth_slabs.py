"""The benchmark's traffic: a ring of pre-made WIBEth batch slabs per APA.

One general generator reads every traffic file (``traffic/<name>.json``):
each slab is ``frames_per_batch`` frames on each link of noise around a
pedestal with Poisson-many pulses, the JAX package's bench source
(``scripts/bench_app_rtf.py:64-89``) made in bulk on the device from the
seed, with no Python step per pulse.  A sample saturates at the 14-bit
limit.  Each APA draws from its own seed stream.

The readout retains raw frames zero-copy, so a slab is never rewritten
while it may still be referenced: the ring holds at least as many slabs
as the system module asks for, and reusing a slab rewrites only its headers
(timestamps and sequence ids, continuous over the whole stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.frames import (ADC_BITS, CHANNELS, CLOCKS_PER_FRAME,
                               FRAME_BYTES, HEADER_U32, TICKS,
                               WORDS_PER_TICK)

TS0 = 0x1000000


def seed_streams(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds drawn from the run's seed."""
    children = np.random.SeedSequence(int(seed)).spawn(n)
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for c in children]


def pack_frames(adcs: torch.Tensor) -> torch.Tensor:
    """(L, N, 64 ticks, 64 channels) samples -> (L, N, 1800) int32 frame
    words with the ADC region packed (14 bits a channel, little-endian
    bit stream per tick) and the header words zero."""
    L, N = adcs.shape[:2]
    dev = adcs.device
    bit = ADC_BITS * torch.arange(CHANNELS, device=dev)
    word, shift = bit // 32, bit % 32
    v = adcs.to(torch.int64)
    lo = (v << shift) & 0xFFFFFFFF
    straddles = shift + ADC_BITS > 32
    hi = torch.where(straddles, v >> (32 - shift), torch.zeros_like(v))
    words = torch.zeros((L, N, TICKS, WORDS_PER_TICK), dtype=torch.int64,
                        device=dev)
    words.index_add_(3, word, lo)
    words.index_add_(3, torch.clamp(word + 1, max=WORDS_PER_TICK - 1), hi)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    out = torch.zeros((L, N, FRAME_BYTES // 4), dtype=torch.int32,
                      device=dev)
    out[..., HEADER_U32:] = words.reshape(L, N, -1).to(torch.int32)
    return out


def make_slab(gen: torch.Generator, traffic: dict, L: int, device):
    """One batch slab's samples, (L, N, 64, 64) int32, from ``gen``."""
    N = int(traffic["frames_per_batch"])
    adcs = (traffic["pedestal"] + traffic["noise_sigma"] * torch.randn(
        (L, N, TICKS, CHANNELS), generator=gen, device=device)) \
        .to(torch.int32)
    mean = traffic["pulse_rate_per_channel_frame"] * L * N * CHANNELS
    n = int(torch.poisson(torch.tensor([float(mean)], device=device),
                          generator=gen).item())
    if n:
        def draw(lo, hi):
            return torch.randint(lo, hi, (n,), generator=gen, device=device)
        link, chan = draw(0, L), draw(0, CHANNELS)
        frame, t0 = draw(0, N), draw(0, traffic["pulse_start_ticks"])
        amp = draw(*traffic["pulse_adc"]).to(torch.int32)
        for k in range(traffic["pulse_ticks"]):
            adcs.index_put_((link, frame, t0 + k, chan), amp,
                            accumulate=True)
    return torch.clamp(adcs, 0, (1 << ADC_BITS) - 1)


class Source:
    """Per APA a ring of ``ring`` slabs of ``links`` x ``frames_per_batch``
    WIBEth frames; :meth:`batch` hands out batch b of an APA's stream."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 n_apas: int, ring: int):
        self.L = int(config["links"])
        self.N = int(traffic["frames_per_batch"])
        self.ring = int(ring)
        self.rings = []
        for apa_seed in seed_streams(seed, n_apas):
            gen = torch.Generator(device=device)
            gen.manual_seed(apa_seed)
            slabs = []
            for _ in range(self.ring):
                words = pack_frames(make_slab(gen, traffic, self.L, device))
                # numpy's own allocation (huge-page advice, as every other
                # large host array of the app gets)
                slab = np.empty((self.L, self.N, FRAME_BYTES), np.uint8)
                slab.view(np.int32)[...] = words.cpu().numpy()
                slabs.append(slab)
            self.rings.append(slabs)
        # the constant header bits of each link: det_id, crate, slot, stream
        link = np.arange(self.L, dtype=np.uint64)
        self._w0 = ((np.uint64(config["det_id"]) << np.uint64(6))
                    | (np.uint64(config["crate"]) << np.uint64(12))
                    | ((link // np.uint64(8)) << np.uint64(22))
                    | ((link % np.uint64(8)) << np.uint64(26)))[:, None]
        self._frame = np.arange(self.N, dtype=np.uint64)

    def slab(self, apa: int, b: int) -> np.ndarray:
        """The (L, N, 7200) slab that carries batch ``b`` (its payload)."""
        return self.rings[apa][b % self.ring]

    def batch_ts(self, b: int) -> int:
        """Timestamp of the first tick of batch ``b`` on every link."""
        return TS0 + b * self.N * CLOCKS_PER_FRAME

    def batch(self, apa: int, b: int) -> np.ndarray:
        """Batch ``b`` of APA ``apa``: its slab with the headers rewritten
        for ``b``, continuous with batch b - 1."""
        frames = self.slab(apa, b)
        words = frames.view("<u8")
        seq = (np.uint64(b * self.N) + self._frame) & np.uint64(0xFFF)
        words[..., 0] = self._w0 | (seq << np.uint64(40))
        words[..., 1] = np.uint64(self.batch_ts(b)) \
            + self._frame * np.uint64(CLOCKS_PER_FRAME)
        return frames
