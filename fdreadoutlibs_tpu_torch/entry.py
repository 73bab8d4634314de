"""Entry point of the port: one forward step of the flagship pipeline.

Counterpart of ``__graft_entry__.py::entry()`` (:14-43): WIBEth packed
frame words -> 14-bit unpack -> frugal pedestal -> threshold hit finding ->
device-side hit compaction, with the same inputs (T = 64 ticks of one
link's frame words, a seeded state, one injected pulse) and threshold.

On a CUDA device ``fn`` launches K4 (``ops.ingest.process_packed_frames_
fused``: the unpack inside the kernel) with tc = 64 and 32 slots a channel,
room for every close in 64 ticks (a channel closes at most every second
tick), so it drops nothing, as the JAX entry's dense scan drops nothing;
then ``ops.ingest.compact_on_device`` at ``max_hits`` = 256.  On
``device="cpu"`` it runs K4's plain version.  The multi-device dry run
(``dryrun_multichip``) is not part of this module.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import wibeth
from .ops import TPGConfig, init_chanstate, seed_chanstate
from .ops.ingest import compact_on_device, process_packed_frames_fused
from .ops.tpg import pack_state

T = 64
TC = 64
K_SLOTS = 32
MAX_HITS = 256
CFG = TPGConfig(threshold=150)


def forward(words: torch.Tensor, state: torch.Tensor):
    """words: (T, 28) int32 packed WIBEth ADC rows (the bits of the frame's
    uint32 words); state: (KSTATE, 64) from ``ops.tpg.pack_state``.

    Returns (hits (MAX_HITS, 6) int32 [channel, end_tick, charge, tover,
    peak_adc, peak_time] in canonical order, n_hits as a 0-d tensor,
    new_state), all on the inputs' device."""
    C = wibeth.N_CHANNELS
    slots, nclose, new_state = process_packed_frames_fused(
        words[None], state, CFG, C, tc=TC, k_slots=K_SLOTS)
    packed = compact_on_device(slots, nclose, 0, C, MAX_HITS)
    return packed[:MAX_HITS], packed[MAX_HITS, 0], new_state


def entry(device=None):
    """Return (fn, example_args): the forward step and its inputs on
    ``device`` (None -> "cuda", which raises without a card)."""
    from .apps.apa_readout import resolve_device
    dev = resolve_device("cuda" if device is None else device)
    rng = np.random.default_rng(0)
    frames = wibeth.empty_frames(1)
    adcs = (900 + rng.normal(0, 30, size=(1, T, 64))).astype(np.uint16)
    adcs[0, 20:25, 7] += 2000
    wibeth.set_adcs(frames, adcs)
    words = torch.from_numpy(
        wibeth.frames_bytes_to_u32(frames)[0].view(np.int32)).to(dev)
    C = wibeth.N_CHANNELS
    state = pack_state(seed_chanstate(init_chanstate(C),
                                      adcs[0, 0].astype(np.int32), 8),
                       C, device=dev)
    return forward, (words, state)
