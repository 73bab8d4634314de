"""Multi-APA time-multiplexing scheduler — serve N APAs on one card.

Port of ``fdreadoutlibs_tpu/apps/scheduler.py:1-148``.  The reference
dedicates one CPU thread per ~64-256 channels, so an APA consumes a whole
multi-core host (SURVEY.md §6).  This scheduler round-robins batches from
several APAs through ONE kernel entry, ``ops.ingest.process_packed_frames``
(the device unpack, then K2 on the plain samples): each APA keeps its own
(KSTATE, C) state tensor on the device, and a "context switch" is nothing
more than passing a different APA's state to the same launch.

CUDA launches are asynchronous: submitting APA k's batch enqueues its
device work and returns APA k's *previous* batch, decoded by
``ops.ingest.collect_hits`` (compaction on the device, one fetch), so the
host framing of one APA overlaps the device work of another.

The APAs are not put on one launch's channel axis: each APA's batch is its
own launch, so each APA drops exactly what a single-APA
``StreamingIngest`` of its batches drops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import wibeth
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.config import TPGConfig
from ..ops.ingest import collect_hits, process_packed_frames
from ..ops.tpg import auto_tc, pack_state
from ..utils.tuning import kernel_knobs
from .apa_readout import resolve_device


class MultiAPAScheduler:
    """Round-robin N independent APA streams through one kernel entry.

    Every APA presents the same geometry (n_links links of 64 channels);
    per-APA state tensors live on ``device`` between calls.

    ``device`` "cuda" (the default; raises without a card) launches K2;
    "cpu" runs K2's plain version.  ``tc`` (None -> ``kernel_knobs``) caps
    the chunk as ``auto_tc`` picks it.  A batch fetches at most
    max(2048, 2 x channels) hits (``collect_hits``); the overflow counts as
    dropped.  The JAX package's TPU knobs ``unroll``, ``interpret`` and
    ``vmem_limit_mb`` are refused (not parameters): the device alone
    selects the kernel or its plain version.
    """

    def __init__(self, cfg: TPGConfig, n_apas: int, n_links: int = 40,
                 tc: int | None = None, k_slots: int = 2,
                 rs_memory_factor=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        # per-channel RS memory factors (threshold-on-collection), shared
        # by every APA (same geometry); scalar default = cfg value
        if rs_memory_factor is None:
            rs_memory_factor = cfg.rs_memory_factor_x10
        else:
            rs_memory_factor = np.asarray(rs_memory_factor)
            n_ch = n_links * wibeth.N_CHANNELS
            if rs_memory_factor.shape != (n_ch,):
                raise ValueError(
                    f"rs_memory_factor must be scalar or ({n_ch},), "
                    f"got shape {rs_memory_factor.shape}")
            cfg.check_memory_factors(rs_memory_factor)
        self.rs_memory_factor = rs_memory_factor
        self.n_apas = n_apas
        self.n_links = n_links
        self.n_channels = n_links * wibeth.N_CHANNELS
        # explicit args win; else tuned file (FDREADOUT_TUNED); else
        # the shipped per-algorithm table
        knobs = kernel_knobs(cfg, tc)
        self.tc = knobs["tc"]
        self.fir_twopass = knobs["fir_twopass"]
        self.geometry = knobs["geometry"]
        self.k_slots = k_slots
        self._stacks = [None] * n_apas          # per-APA device state
        self._pending = [None] * n_apas         # (slots, nclose, tick_off)
        self._tick_offset = [0] * n_apas
        self._batches = [0] * n_apas

    def _ensure_state(self, apa: int, words: np.ndarray) -> None:
        """Seed APA ``apa``'s state from each channel's first sample."""
        first = wibeth.unpack_frames(torch.from_numpy(
            np.ascontiguousarray(words[:, 0]).view(np.int32)))
        state = seed_chanstate(init_chanstate(self.n_channels),
                               first.reshape(-1).numpy(),
                               self.rs_memory_factor)
        self._stacks[apa] = pack_state(state, self.n_channels,
                                       device=self.device)

    def submit(self, apa: int, frames_links: np.ndarray):
        """frames_links: (L, N, 7200) one batch for one APA.  Returns the
        decoded hits of THIS APA's previous batch (pipelined), or None."""
        L, N, _ = frames_links.shape
        if L != self.n_links:
            raise ValueError(f"APA {apa}: expected {self.n_links} links, "
                             f"got {L}")
        T = N * wibeth.N_TIME_SAMPLES
        words = wibeth.frames_bytes_to_u32(
            frames_links.reshape(-1, wibeth.FRAME_SIZE)).reshape(L, T, 28)
        return self.submit_words(apa, words)

    def submit_words(self, apa: int, words: np.ndarray):
        """words: (L, T, 28) uint32 packed rows of one APA's batch.  Same
        return as :meth:`submit`."""
        L, T, _ = words.shape
        if self._stacks[apa] is None:
            self._ensure_state(apa, words)
        out = self.collect(apa)
        feed = torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(self.device)
        slots, nclose, self._stacks[apa] = process_packed_frames(
            feed, self._stacks[apa], self.cfg, self.n_channels,
            tc=auto_tc(T, cap=self.tc), k_slots=self.k_slots,
            fir_twopass=self.fir_twopass, geometry=self.geometry)
        self._pending[apa] = (slots, nclose, self._tick_offset[apa])
        self._tick_offset[apa] += T
        self._batches[apa] += 1
        return out

    def collect(self, apa: int):
        """Block on and decode APA ``apa``'s in-flight batch, if any:
        (hits, dropped) with end ticks on the APA's own stream clock."""
        if self._pending[apa] is None:
            return None
        slots, nclose, tick_offset = self._pending[apa]
        self._pending[apa] = None
        return collect_hits(slots, nclose, self.n_channels,
                            tick_offset=tick_offset)

    def flush(self):
        """Collect every APA's in-flight batch: {apa: (hits, dropped)}."""
        out = {}
        for apa in range(self.n_apas):
            got = self.collect(apa)
            if got is not None:
                out[apa] = got
        return out

    def get_info(self) -> dict:
        return {"n_apas": self.n_apas,
                "n_channels_per_apa": self.n_channels,
                "batches": list(self._batches),
                "ticks": list(self._tick_offset)}
