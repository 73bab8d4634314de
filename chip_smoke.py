#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. device  — requires a CUDA card of capability (9, 0); prints its name and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build   — compiles the kernel library's translation units
   (``fdreadoutlibs_tpu_torch/csrc/tpg*.cu``, one ``nvcc`` each, all at
   once) and summarizes ``ptxas -v`` (registers, stack, spills; the FIR
   kernels side by side: the pipeline's K3 and K3b on plain, time2, packed
   and words14 rows (the gather and the slab), K2b's FIR on int16 rows, K5
   and staged arm; every instantiation of the threshold families'
   pipeline, K1, K2, K4, K4b-gather, K4b-slab and K2b with both emission
   layouts and their staged arms; it fails if a K4b or K3b instantiation
   spills);
3. kernel  — the hand-written kernel against its plain PyTorch version on
   the card at T=8192 ticks x 2560 channels (tc=256, K=4): K1 (time2
   datapath) and K2 (plain-sample datapath) for SimpleThreshold, AbsRS and
   StandardRS (K2 also for AbsRS with the float running sum, ``rs_float``;
   K2's time beside K1's on the same samples for each family, both the
   pipeline),
   K3 (FIR, threshold 5) on both datapaths with and without
   peak tracking.  Slots, nclose and state must be bit-equal and some
   chunk must close more than K hits (drops exercised); both are timed.
   A time2 case whose words split back into the ADCs takes the plain
   datapath's plain result for them (the same function of the same
   samples), except the reported K1 case, which runs its own.
   K4 (the in-kernel 14-bit unpack) takes the same ADCs packed as frame
   words (L, T, 28) and as words14 rows (T, WR, 7, 128) for the four
   families: the torch unpack of each must give back the ADCs, so K4's
   plain version is the plain result of K2 (K3 for FIR) on them, and K4's
   slots, nclose and state must equal it bit for bit;
4. apa slice — the production APA app (40 WIBEth links, AbsRS,
   threshold-on-collection) on each of its four feeds: time2 (host codec,
   K1), fused (frame words, K4), words14 (host relayout, K4) and packed
   (device unpack, K2).  Per feed: one warm-up batch of 128 frames per link
   (timed apart, as set-up), a steady window of 16 batches for the
   end-to-end RTF and ``latency_info``, the feed's kernel launched once per
   batch, the first 2 batches' hits equal to one shared plain result (the
   kernel's plain version plus the same compaction on the same ADCs), the
   bytes copied into words pages (``words_copy_bytes``: none on the time2
   feed, whose codec reads the frames in place), and a per-stage split of
   one batch;
5. wib2 slice — 10 WIB2 links (2560 channels) through 10 per-link
   ``WIB2FrameProcessor``s, FIR threshold 5, batches of 512 superchunks
   per link (T = 6144 ticks = 3.146 ms), once with the packed ingest (device
   unpack, K2 + K3) and once with the time2 feed (host codec, K3): one
   warm-up batch, 8 steady batches (end-to-end RTF, ms per batch), one
   launch per link per batch, TPs sent and no timestamp errors, batches
   0-1 of every link equal to the plain version with the processors'
   seeding, tc and compaction; then a per-stage split of one batch;
6. protowib slice — 10 ProtoWIB links (96 collection + 160 induction
   channels each) through 10 per-link ``WIBFrameProcessor``s (pallas
   backend, FIR threshold 5 on both planes), batches of 512 superchunks per
   link (T = 6144 ticks = 3.072 ms), three times: the packed feed (device
   decode) under a tuned file naming ``twopass`` 0 (K2 + K3), the packed
   feed under ``twopass`` 2 and the time2 feed under ``twopass`` 1 (K5,
   the two-pass FIR schedule).  Per run one warm-up batch and 8 steady
   batches (end-to-end RTF, ms per batch), one launch per plane per link
   per batch, TPs sent and no timestamp errors, batches 0-1 of every link
   and plane equal to the plain version with the processors' seeding, tc
   and compaction, the same hits and TPs in all three runs, and a
   per-stage split of one batch;
7. kernel entries — the entries that reach the variants of ``_tpg_kernel``
   (``pallas_tpg.py``)
   at APA width (2560 channels), 8 windows of 8192 ticks carrying state:
   ``ingest.process_words14_feed(slab=True)`` (K4b-slab) on the words14
   rows of ``make_batch`` frames, the same rows through
   ``tpg.process_window(packed14="words14", words14_gather=True)``
   (K4b-gather), ``process_window`` on the int16 samples (K2b; all three
   AbsRS 150) and ``process_window(fir_packed=True)`` (K2 + K3b, FIR 5).
   Each window is copied to the card, run, compacted on the device and
   fetched; windows 0-1 equal the plain version's hits; ms per window (p50)
   and RTF per entry.

8. probes — the probe entries at full size, each checking parity before it
   times anything: P1 ``probes.roofline.probe_arms`` (the int32 issue rate
   and dependent-op latency, every arm at 20 000 and 120 000 iterations,
   with the loop's machine code read) and the TPG kernels of phase 3
   against it; P2 ``probes.i16_ops.support_matrix`` and ``throughput_ab``
   (the one-op int16 record and the int32 / int16 / two-per-register mix);
   P3 ``probes.swar_frugal.run`` (the frugal chain, one channel per
   register against two, 8192 x 2560); ``probes.slots_ab.run`` (the direct
   store against ``SLOT_WORD_CARRY`` on every datapath, 8192 x 2560,
   k_slots 1).  P1 holds every arm (each ilp at each geometry it is timed
   at) and P3 every arm to the plain version inside the entry, and their
   rows carry the error measured there; the one-op and mix kernels are held
   once more at their rows' shapes; the carry layout is run on the reported
   case of K1-K4 and the variants, held bit-equal to the plain result of
   phase 3 and timed beside the direct store;
9. detector slice — ``apps.detector_readout.DetectorReadoutApp`` at full
   width: the TPC arm at 40 WIBEth links (2560 channels) on the fused feed
   (K4), 128 frames per link per batch; the PDS arm at 10 DAPHNE-stream
   links (40 channels, K2), 4 superchunks (3072 ticks) per link per batch;
   the TDE arm at 12 links of 64 channels, one 5965-sample cycle per link
   per batch under ``run_model(backend="pallas")`` (K2 on windows of 512
   ticks).  One warm-up batch and 8 steady batches, once sync and once
   pipelined: per-arm ms per batch and RTF, K4 once per batch and K2 once
   per PDS batch and 12 times per TDE link per batch, no timestamp errors,
   every drain of the merged TPSet stream time-ordered, both runs' TPSet
   streams equal; batches 0-1 of every arm equal to the plain version with
   the arm's seeding, windows, K and compaction; ``request_raw`` returns
   payloads and ``record_fragment`` writes one fragment per arm that reads
   back with the requested source id and payloads; then the PDS arm's K2
   alone on its batch (the one-chain-per-channel bound on the arm's RTF)
   and one TDE window's K2;
10. modules slice — ``apps.scheduler.MultiAPAScheduler`` at 4 APAs x 40
   WIBEth links (4 x 2560 channels; AbsRS 150, phase 4's
   threshold-on-collection memory factors, k_slots 4): one warm-up batch
   and 8 steady batches of 128 frames an APA, submitted round-robin in a
   seeded shuffled order (K2 once per submit); the aggregate RTF (4 x
   detector seconds over wall seconds), ms per submit p50 and the stage
   split of one submit (words copy, H2D, unpack, K2, compaction, fetch).
   APA 0 takes phase 4's batches and equals phase 4's plain result on
   batches 0-1 (end ticks shifted by the batch's offset, the same cap of
   max(2048, 2C)); APAs 1-3 take phase 4's batches from other starts with
   the links rotated and each equals a single-APA ``StreamingIngest`` on
   the card, hits and dropped counts; APA 1's batch 0 equals the plain
   version; ``get_info`` counts 9 batches an APA.  Then ``entry()`` on the
   card (K4 once) against ``entry(device="cpu")``; the CLI in-process
   (``cli.main``): ``make-zeros`` -> ``pattern-generator -p golden`` ->
   ``tpg-emulator -i pallas`` (2 hits, the reference's TP file),
   ``compare-backends -b reference scan pallas`` on 32 frames of one link
   (MATCH), and ``profile`` at 2560 channels x 8192 ticks x 4 windows for
   AbsRS (K2), FIR (K3) and FIR ``--fir-twopass 2`` (K5), each trace's
   summary naming ``pipe_kernel``; last a WIBEth processor on the card
   checkpointed with its state on the card and a hit in flight, restored
   into a fresh processor, equal to the uninterrupted run.
11. parallel slice — ``parallel.APAPipeline`` at full width on phase 4's
   data (40 links, AbsRS 150 with phase 4's memory factors, tc 512, K 8,
   512 hits a link, backend "pallas") in each ingest, canonical (K2),
   fused (K4) and time2 (K1), on a 1-shard and an 8-shard mesh on the card
   (5 links a shard, each on its own CUDA stream): 1 warm-up and 8 steady
   batches each, ms per batch p50 and RTF with the fetch, the kernel once
   a shard a batch, a stage split of one batch (host words, relayout,
   H2D, kernels on the shards' streams and on one stream, compaction,
   fetch); batches 0-1 equal the plain version with the same tc, K and
   per-link cap, and all six runs equal each other (hits, n_hits, totals,
   dropped, final state).  Then the 8-shard state after batch 1 through
   ``save_sharded_state``, restored into fresh 8- and 1-shard pipelines,
   replays batch 2 as the uninterrupted run, and garbage words on link 20
   leave every other link's hits and state untouched;
   ``DetectorPipeline`` at 4 APAs x 40 links on a (4, 2) mesh (aggregate
   RTF; each APA equal to an ``APAPipeline`` of its own batches, each
   total the sum of its n_hits); ``dryrun_multichip(8)`` on the card; and
   ``probes.soak`` at 2560 channels x 4096 ticks, 40 windows, in its four
   ingests (K2, K4 frames, K4 words14, K1), each ``SOAK OK``.
12. tool slice — the fuzzers and the knob tuner on the card, while the tpg
   library of one non-shipped geometry (``group`` 16, ``stage_ticks`` 64,
   ``stages`` 4: ``probes.autotune.QUICK_GEOMETRY``) builds beside them:
   ``probes.fuzz_sweep`` over 20 seeds (K2, K3 on every case, the time2
   feed and FIR's lifted two-pass schedule, K1 and K5, on every second;
   bit-equal to the plain version and the oracle), ``probes.fuzz_frames``
   with 3 seeds for each of its 7 rigs (corrupt payloads through every
   processor's "pallas" backend on the card: no exception, the seq/ts
   errors seen, the TPs equal to the plain version's and to the
   reference's under the kernel's contract), ``probes.fuzz_tp_path`` (20
   host cases and a hammer); the registers and spills of both geometries'
   libraries; then ``probes.autotune --quick --confirm 2`` on the four
   families at 2560 x 8192 (the time2 feed: K1, and K3 / K5 for FIR),
   every candidate bit-equal to the plain version at its tc and k and the
   geometry to the shipped library, its table (ms per window per
   candidate, the confirmed entry per family); and the written file, read
   back through ``kernel_knobs`` (``FDREADOUT_TUNED`` restored after),
   drives one APA batch of phase 4's data on the time2 feed, equal to the
   plain app at those knobs.
13. bench — ``fdreadoutlibs_tpu_torch.bench.run`` at reduced counts
   through its own parameters (1 trial, 2 windows a chain, the app's 1 +
   2 batches, the latency arm's 1 + 2, 0.25 s a host codec): the headline
   and the four families at 2560 x 8192, the six production variants, the
   host codecs and TP path, the latency cell on each feed, the four
   frontends (DAPHNE-stream with one traced chain), the app's RTF (time2,
   fused and packed feeds, its transfer timed) and the compaction A/B.
   The line must round-trip as JSON with every key of ``bench.py``'s line, no
   ``*_error``, ``"parity": true`` (each family's and variant's first
   window equal to the plain version on the card) and every RTF above 0.

Phase 2 also builds the port's native host codecs (``native/``) and fails
if they do not load, so no host stage is timed on the numpy fallback.
Phase 3 also holds K5 (fir_twopass 1 and 2, peaks off and on, plain and
time2 datapaths) bit-equal to K3 and to the plain result K3 was held to on
the same inputs, and to K5's own plain version once per schedule, and
times both in the same call (every kernel is the pipeline of
``csrc/tpg.cuh``; phase 8 reads each of its warps' group loops in the
machine code, K4b-slab's unpack pass too, and gives the chain floor beside
the time).  It then holds
the variants of the fused tick on the same inputs, each timed beside the
kernel it varies: K3b (``fir_packed``) on K3's plain (peaks off and on)
and time2 feeds and on K4's frame words and words14 rows (K4's decode, the
gather and the slab, the slab also at tc = 1024), each equal to K3's mode
on the same feed and to its own plain version, timed in turns with K3's
mode; K2b on the four families' ADCs as int16, equal to K2's (K3's)
plain result; K4b-slab (four families) and K4b-gather (AbsRS, FIR) on K4's
words14 rows, equal to K4's plain result; each held once to its own plain
version.

The last lines are the card's name and power limit, one JSON object with
the kernels (each with the launches of its kernel function on the main
paths, phases 9-13 included, ``tpg.kernel_of``, and beside them
``datapath_launches``, every
launch whose datapath holds it, ``tpg.kernels_of``; its error against
the plain version, its time, the plain version's, and its bound: the
larger of the bytes it must move over 3.35 TB/s and its int32 operations
over the int32 rate P1 sustained in this run, never less than 132 SMs x 64
lanes at the measured SM clock), and the result
line ``{"ok": true, "device": {...}}``.  Imports only ``torch``, numpy and
the port.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from fdreadoutlibs_tpu_torch import bench, cli, native, probes
from fdreadoutlibs_tpu_torch import entry as entry_mod
from fdreadoutlibs_tpu_torch.apps import detector_readout, pds_readout
from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.apps.scheduler import MultiAPAScheduler
from fdreadoutlibs_tpu_torch.entry import dryrun_multichip, entry
from fdreadoutlibs_tpu_torch.formats.bitpack import unpack_14bit
from fdreadoutlibs_tpu_torch.formats import daphne, protowib, tde, wib2, wibeth
from fdreadoutlibs_tpu_torch.models.algorithms import (
    K_SLOTS as RUN_MODEL_K, WINDOW as RUN_MODEL_WINDOW)
from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, _build,
                                         ingest, init_chanstate, patterns,
                                         seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.ops.hits import concat_hits
from fdreadoutlibs_tpu_torch.ops.ingest import (StreamingIngest,
                                                compact_on_device,
                                                unpack_compact)
from fdreadoutlibs_tpu_torch.parallel import (APAPipeline, DetectorPipeline,
                                              make_apa_link_mesh,
                                              make_link_mesh)
from fdreadoutlibs_tpu_torch.parallel import apa as par_apa
from fdreadoutlibs_tpu_torch.probes import (autotune, fir_pipe, fuzz_frames,
                                            fuzz_sweep, fuzz_tp_path,
                                            i16_ops, roofline, slots_ab, soak,
                                            swar_frugal)
from fdreadoutlibs_tpu_torch.probes.roofline import (DECODE_OPS, INT32_LANES,
                                                     OPS_PER_TICK)
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor, \
    WIBEthFrameProcessor, WIBFrameProcessor
from fdreadoutlibs_tpu_torch.stream import tde as tde_stream
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             protowib_superchunks,
                                             time2_words, tpg_stream,
                                             wib2_superchunks)
from fdreadoutlibs_tpu_torch.tp.recorder import FragmentRecorder
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
from fdreadoutlibs_tpu_torch.utils import checkpoint
from fdreadoutlibs_tpu_torch.utils.logging import (device_records,
                                                   device_trace, trace_counts)
from fdreadoutlibs_tpu_torch.utils.preflight import (device_preflight,
                                                     nvidia_smi, sm_clock_mhz)
from fdreadoutlibs_tpu_torch.utils.tuning import kernel_knobs

N_LINKS = 40                 # one APA
C_APA = N_LINKS * 64         # 2560 channels
T_APA = 8192                 # ticks per APA batch (128 frames)
TC, K = 256, 4
FRAMES = 128
N_WARM, N_TIMED, N_CHECKED = 1, 16, 2
SEED = 20260
# the APA app's feeds: constructor flags and the kernel each launches
APP_FEEDS = {"time2": ({"time2_feed": True}, "K1"),
             "fused": ({"fused_unpack": True}, "K4"),
             "words14": ({"words14_feed": True}, "K4"),
             "packed": ({}, "K2")}

WIB2_LINKS = 10              # 10 x 256 = 2560 channels
WIB2_SC = 512                # superchunks per link per batch
WIB2_T = WIB2_SC * wib2.FRAMES_PER_SUPERCHUNK      # 6144 ticks
WIB2_TICK_S = 32 / 62.5e6    # 512 ns
WIB2_TIMED = 8

PW_LINKS = 10                # 10 x 256 = 2560 channels
PW_SC = 512                  # superchunks per link per batch
PW_T = PW_SC * protowib.FRAMES_PER_SUPERCHUNK      # 6144 ticks
PW_TICK_S = 25 / 50e6        # 500 ns
PW_TIMED = 8
# the ProtoWIB runs: (label, time2 feed, the tuned file's twopass)
PW_RUNS = (("packed, twopass 0", False, 0), ("packed, twopass 2", False, 2),
           ("time2, twopass 1", True, 1))
PW_PLANES = (("collection", protowib.COLLECTION_INDEX_TO_CHAN),
             ("induction", protowib.INDUCTION_INDEX_TO_CHAN))

KERNELS = tpg.KERNELS
REPLACES = {"K1": "fdreadoutlibs_tpu/ops/pallas_tpg.py:439",
            "K2": "fdreadoutlibs_tpu/ops/pallas_tpg.py:399",
            "K3": "fdreadoutlibs_tpu/ops/pallas_tpg.py:464",
            "K4": "fdreadoutlibs_tpu/ops/pallas_tpg.py:241",
            "K5": "fdreadoutlibs_tpu/ops/pallas_tpg.py:585",
            "K2b": "fdreadoutlibs_tpu/ops/pallas_tpg.py:475",
            "K3b": "fdreadoutlibs_tpu/ops/pallas_tpg.py:466",
            "K4b-slab": "fdreadoutlibs_tpu/ops/pallas_tpg.py:308",
            "K4b-gather": "fdreadoutlibs_tpu/ops/pallas_tpg.py:268"}
# the kernels are written in the shared header; csrc/tpg_*.cu instantiate
SOURCE = "fdreadoutlibs_tpu_torch/csrc/tpg.cuh"

# The bound of a kernel case: the larger of its bytes (feed read once,
# state read and written once, slots and nclose written once) over the
# HBM rate, and its int32 operations over the int32 rate the issue probe
# sustained in this run on an add/shift/xor mix (phase 8; never less than
# 132 SMs x 64 INT32 lanes per clock at the measured SM clock: the card
# does more than the nominal lanes on such a mix).  Operations
# per tick per channel of the function computed and of the feed decode:
# probes/roofline.py::OPS_PER_TICK and DECODE_OPS, the one copy (K5 does
# FirChannel's work in passes).  A variant is bounded by the function
# it computes, not by its own schedule: K3b by K3's ticks, K2b by its
# family's ticks (with the int16 state's bytes), K4b by K4's decode; the
# carry layout by the kernel it varies.
HBM_BYTES_PER_S = 3.35e12


# launches of each kernel function on the main paths (tpg.kernel_of: K2 the
# threshold families on plain samples, K3 the FIR fused tick), added up
# right after each run that drives a main path
function_launches = {k: 0 for k in KERNELS}


def tally() -> None:
    """Add the kernel functions' launches of the run just driven."""
    for k, n in tpg.process_window.function_launches.items():
        function_launches[k] += n


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[{name}] start", flush=True)

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                print(f"[{name}] ok in {time.perf_counter() - self.t0:.3f} s",
                      flush=True)
    return _Phase()


def time_kernel(fn, n: int, flush: torch.Tensor) -> float:
    """Mean ms per call over n calls, each after an L2 flush (the kernel
    reads a feed that was just copied in, not a warm cache)."""
    fn()
    ms = 0.0
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms += a.elapsed_time(b)
    return ms / n


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    stack = [int(s) for s in re.findall(r"(\d+) bytes stack frame", log)]
    spill = [int(s) for s in re.findall(r"(\d+) bytes spill", log)]
    return (f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"stack frame max {max(stack)} B, spills max {max(spill)} B")


def ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from the
    ``ptxas -v`` report."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


# csrc/tpg.cuh::pipe_kernel's modes (its second template argument) and
# the encodings (its first)
PIPE_MODES = {"0": "staged arm", "1": "K3", "2": "K5 twopass 1",
              "3": "K5 twopass 2", "4": "threshold"}
ENCODINGS = {"0": "plain", "1": "time2", "2": "packed14", "3": "gather14",
             "4": "slab14", "5": "int16"}
# the kernel the threshold mode runs on each encoding (ROADMAP.md's names)
THRESHOLD_KERNEL = {"0": "K2", "1": "K1", "2": "K4", "3": "K4b-gather",
                    "4": "K4b-slab", "5": "K2b"}
# a kernel's name: its template, its channel type and arguments, and the
# emission layout (the last template argument)
_PIPE = re.compile(r"pipe_kernelILi(\d)ELi(\d)EN\w*?\d+(FirChannel|"
                   r"FirPackedChannel|ThresholdChannel)I(\w+?)EELb(\d)EEEv")
_CARRY = re.compile(r"Lb(\d)EEEvN3tpg6ParamsE$")
_THRESHOLDS = {"0": "SimpleThreshold", "1": "AbsRS", "2": "StandardRS"}


def pipe_name(name: str) -> str | None:
    """A short name of a pipeline kernel ("K2 AbsRS plain gated floor
    rs_float carry", "K2b AbsRS int16 floor", "K3 packed14 peaks", "K3b
    slab14 peaks carry", ...), or None for another kernel."""
    m = _PIPE.search(name)
    if m is None:
        return None
    enc, mode, channel, args, carry = m.groups()
    flags = re.findall(r"L([ib])(\d)E", args)
    words = [PIPE_MODES[mode]]
    if channel == "ThresholdChannel":
        fam, gated, floor, _, rs_float = (v for _, v in flags)
        if mode == "4":
            words[0] = THRESHOLD_KERNEL[enc]
        words.append(_THRESHOLDS[fam])
        words += [w for w, v in (("gated", gated), ("floor", floor),
                                 ("rs_float", rs_float)) if v == "1"]
    else:
        if channel == "FirPackedChannel":
            words[0] = "K3b"
        gated, peaks, avx = (v for _, v in flags[:3])
        words += [w for w, v in (("gated", gated), ("peaks", peaks),
                                 ("naive", "0" if avx == "1" else "1"))
                  if v == "1"]
    words.insert(1, ENCODINGS[enc])
    if carry == "1":
        words.append("carry")
    return " ".join(words)


def fir_registers(kernels: dict) -> dict:
    """The FIR kernels, all the pipeline's (K3 and K3b on plain, time2,
    packed and words14 rows through the gather and the slab, K2b's FIR on
    int16 rows in K3's mode, K5 on every encoding, the staged arm; direct
    store and carry): {kernel: {"peaks" or "no peaks": (min regs, max regs,
    max spill B)}}."""
    out = {}
    for name, (regs, spill) in kernels.items():
        mp = _PIPE.search(name)
        if mp is None or mp.group(3) == "ThresholdChannel":
            continue
        enc, mode, channel, args, carry = mp.groups()
        kern = ("K2b (K3's mode)" if enc == "5" else
                "K3b" if channel == "FirPackedChannel" else PIPE_MODES[mode]) \
            + (f" {ENCODINGS[enc]}" if enc in ("2", "3", "4") else "") + \
            (" carry" if carry == "1" else "")
        peaks = re.findall(r"Lb(\d)E", args)[1]
        key = "peaks" if peaks == "1" else "no peaks"
        lo, hi, sp = out.setdefault(kern, {}).get(key, (999, 0, 0))
        out[kern][key] = (min(lo, regs), max(hi, regs), max(sp, spill))
    return out


def threshold_registers(kernels: dict) -> dict:
    """Every instantiation of the threshold families' pipeline (K1, K2, K4,
    K2b, direct store and carry, and their staged arms): {short name:
    [registers, spill store B]}."""
    return {pipe_name(name): list(v) for name, v in sorted(kernels.items())
            if "ThresholdChannel" in name and pipe_name(name) is not None}


def plain_app_hits(adcs_batches, rmf, cfg, k_slots: int, dev):
    """What the APA app must fetch for consecutive batches of (T, C) ADCs:
    the kernel's plain version, with the app's state seeding, chunking and
    compaction, carrying state across batches.  Yields (hits, dropped)."""
    state = None
    for adcs in adcs_batches:
        T, C = adcs.shape
        if state is None:
            state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0],
                                                  rmf), C, device=dev)
        tc = tpg.auto_tc(T, cap=kernel_knobs(cfg)["tc"])
        feed = torch.from_numpy(time2_words(adcs)).to(dev)
        slots, nclose, state = tpg.process_window_plain(feed, state, cfg,
                                                        tc, k_slots)
        yield unpack_compact(compact_on_device(slots, nclose, 0, C,
                                               max(2048, 2 * C)))


def plain_processor_hits(adcs_batches, procs, dev):
    """What the per-link WIB2 processors must fetch for consecutive batches
    of (L, T, 256) ADCs: the kernel's plain version over all links' channels
    at once (channels are independent), on the plain datapath, with
    their seeding, tc, K and compaction per link, carrying state.  Yields
    per batch a list of (hits, dropped) per link."""
    p0 = procs[0]
    C = p0.N_CHANNELS
    L = len(procs)
    state = None
    for adcs in adcs_batches:
        T = adcs.shape[1]
        flat = adcs.transpose(1, 0, 2).reshape(T, L * C)
        if state is None:
            rmf = np.concatenate([p.register_memory_factor for p in procs])
            state = tpg.pack_state(seed_chanstate(
                init_chanstate(L * C), flat[0], rmf), L * C, device=dev)
        tc = tpg.auto_tc(T, cap=kernel_knobs(p0.tpg_cfg)["tc"])
        slots, nclose, state = tpg.process_window_plain(
            torch.from_numpy(flat).to(dev), state, p0.tpg_cfg, tc,
            p0.k_slots, time_packed=False)
        yield [unpack_compact(compact_on_device(
            slots[..., l * C:(l + 1) * C].contiguous(),
            nclose[:, l * C:(l + 1) * C].contiguous(), 0, C,
            max(2048, 2 * C))) for l in range(L)]


def check_equal(label: str, got, want) -> int:
    """Max |difference| of (slots, nclose, state); raises unless 0."""
    err = 0
    for g, w, what in zip(got, want, ("slots", "nclose", "state")):
        d = int((g.long() - w.long()).abs().max())
        err = max(err, d)
        if d:
            raise AssertionError(f"{label}: kernel {what} differs from "
                                 f"the plain version (max |d| {d})")
    return err


def check_strong(label: str, got) -> str:
    """Raise unless the window closed hits and overflowed K somewhere."""
    n_hits = int((got[0][:, :, -1] != 0).sum())
    n_over = int(got[1].max())
    if n_hits == 0 or n_over <= K:
        raise AssertionError(f"{label}: weak check ({n_hits} hits, max "
                             f"closes per chunk {n_over})")
    return f"{n_hits} hits, max {n_over} closes/chunk"


def split_time2(words: torch.Tensor) -> torch.Tensor:
    """(T/2, C) time2 words -> (T, C) samples: tick 2j from the low 16
    bits (sign-extended), 2j+1 from the high 16."""
    lo, hi = (words << 16) >> 16, words >> 16
    return torch.stack([lo, hi], dim=1).reshape(-1, words.shape[1])


def kernel_work(feed, cfg, encoding: str, T: int, C: int) -> dict:
    """Bytes and int32 operations one launch must do on these inputs (the
    state in the feed's element size for the int16 mode)."""
    n_chunks = T // TC
    out = n_chunks * K * tpg.record_words(cfg) * C + n_chunks * C
    state_bytes = 2 * tpg.KSTATE * C * feed.element_size()
    return {"bytes": feed.numel() * feed.element_size() + state_bytes
            + out * 4, "ops": T * C * (OPS_PER_TICK[cfg.algorithm.value]
                                       + DECODE_OPS[encoding])}


def kernel_vs_plain(dev):
    """Phase 3.  Returns {kernel: {"max_abs_err", "ms", "plain_ms",
    "timed", "work"}} for the variant reported per kernel (K5 also
    carries K3's time on the same inputs in this call)."""
    fir = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    thr = {"SimpleThreshold": TPGConfig(threshold=150),
           "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
           "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                   threshold=150)}
    # the plain datapath first: a time2 case whose words split back into
    # the same ADCs takes that case's plain result (the same function of the
    # same samples); the reported K1 case runs its own plain version
    # (the float running sum, rs_float, once on the plain datapath)
    cases = [("K2", f"{n} plain", c, False) for n, c in thr.items()] + \
        [("K2", "AbsRS plain rs_float",
          replace(thr["AbsRS"], rs_float=True), False),
         ("K3", "FIR plain", fir, False),
         ("K3", "FIR plain peaks", replace(fir, track_peaks=True), False)] + \
        [("K1", f"{n} time2", c, True) for n, c in thr.items()] + \
        [("K3", "FIR time2", fir, True),
         ("K3", "FIR time2 peaks", replace(fir, track_peaks=True), True)]
    reported = {"K1": "AbsRS time2", "K2": "AbsRS plain", "K3": "FIR plain",
                "K4": "AbsRS frames", "K5": "FIR plain twopass 2",
                "K2b": "AbsRS int16", "K3b": "FIR plain fir_packed",
                "K4b-slab": "AbsRS words14 slab",
                "K4b-gather": "AbsRS words14 gather"}
    adcs, rmf = tpg_stream(T_APA, C_APA, TC, K, SEED)
    fadcs = fir_stream(T_APA, C_APA, TC, K, SEED)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}
    plain = {}      # plain-datapath label -> (adcs, cfg, state, result)
    k3 = {}         # K3 label -> (feed, state, cfg, time2, result, ms)
    k4 = {}         # K4 label -> (feed, ms)

    case_ms = {}    # label -> the kernel's ms

    def record(kern, label, err, ms, plain_ms, work, base=None, case=None):
        """``base``: (the kernel it varies, its ms on the same inputs);
        ``case``: (the launch, the plain result) of the reported case, kept
        for the carry layout's comparison in phase 8."""
        prev = out.get(kern, {"max_abs_err": 0})
        entry = {"max_abs_err": max(prev["max_abs_err"], err)}
        if label == reported[kern]:
            entry.update(ms=ms, plain_ms=plain_ms, timed=label, work=work,
                         base=base, case=case)
        out[kern] = {**prev, **entry}

    for kern, label, cfg, time2 in cases:
        a = fadcs if cfg.algorithm == Algorithm.FIR else adcs
        state = tpg.pack_state(seed_chanstate(init_chanstate(C_APA), a[0],
                                              rmf), C_APA, device=dev)
        feed = torch.from_numpy(time2_words(a) if time2 else a).to(dev)

        def run(feed=feed, state=state, cfg=cfg, time2=time2):
            return tpg.launch_kernel(feed, state, cfg, TC, K, time2)
        got = run()
        torch.cuda.synchronize()
        same = label.replace("time2", "plain")
        plain_ms = None
        if time2 and label != reported[kern] and same in plain:
            if not torch.equal(split_time2(feed),
                               torch.from_numpy(a).to(dev)):
                raise AssertionError(f"{label}: the time2 words do not "
                                     "split back into the ADCs")
            want = plain[same][3]
        else:
            t0 = time.perf_counter()
            want = tpg.process_window_plain(feed, state, cfg, TC, K, time2)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        err = check_equal(label, got, want)
        what = check_strong(label, got)
        ms = time_kernel(run, 20, flush)
        case_ms[label] = ms
        if not time2:
            plain[label] = (a, cfg, state, want)
        if kern == "K3":
            k3[label] = (feed, state, cfg, time2, got, ms, want)
        print(f"  {kern} {label}: T={T_APA} x {C_APA} ch bit-equal ({what}); "
              f"kernel {ms:.4f} ms/batch"
              + (f", plain {plain_ms:.1f} ms/batch" if plain_ms else
                 f" (plain result of '{same}')"), flush=True)
        record(kern, label, err, ms, plain_ms,
               kernel_work(feed, cfg, "time2" if time2 else "plain", T_APA,
                           C_APA), case=(run, want))

    # K2 beside K1 on the same samples (K1's time2 words split back into
    # K2's rows), both the threshold pipeline, timed in this call
    for fam in thr:
        k2_ms, k1_ms = case_ms[f"{fam} plain"], case_ms[f"{fam} time2"]
        print(f"  K2 (plain rows) vs K1 (time2 rows) on the same {fam} "
              f"samples: {k2_ms:.4f} / {k1_ms:.4f} ms/batch = "
              f"{k2_ms / k1_ms:.4f}", flush=True)

    # K4: the same ADCs as packed words.  Its plain version is the torch
    # unpack and then K2's (K3's) plain loop: the unpack is checked equal to
    # the ADCs, so the plain result above is K4's; the reported case runs
    # the whole plain version again for its time.
    for fam, src in (("SimpleThreshold", "SimpleThreshold plain"),
                     ("AbsRS", "AbsRS plain"),
                     ("StandardRS", "StandardRS plain"), ("FIR", "FIR plain")):
        a, cfg, state, want = plain[src]
        frames = torch.from_numpy(frame_words(a).view(np.int32)).to(dev)
        a_dev = torch.from_numpy(a).to(dev)
        for layout, feed in (("frames", frames),
                             ("words14", ingest.pack_words14(frames))):
            label = f"{fam} {layout}"
            if not torch.equal(tpg.unpack_packed14(feed, layout, C_APA),
                               a_dev):
                raise AssertionError(f"{label}: the torch unpack does not "
                                     "give back the ADCs")

            def run(feed=feed, state=state, cfg=cfg, layout=layout):
                return tpg.launch_kernel(feed, state, cfg, TC, K, False,
                                         layout)
            got = run()
            torch.cuda.synchronize()
            plain_ms = None
            if label == reported["K4"]:
                t0 = time.perf_counter()
                want = tpg.process_window_plain(feed, state, cfg, TC, K,
                                                False, layout)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
            err = check_equal(label, got, want)
            what = check_strong(label, got)
            ms = time_kernel(run, 20, flush)
            print(f"  K4 {label} ({tuple(feed.shape)} int32): bit-equal "
                  f"({what}); kernel {ms:.4f} ms/batch"
                  + (f", plain {plain_ms:.1f} ms/batch" if plain_ms else ""),
                  flush=True)
            record("K4", label, err, ms, plain_ms,
                   kernel_work(feed, cfg, "packed14", T_APA, C_APA),
                   case=(run, want))
            k4[label] = (feed, ms)

    # K5: the two-pass FIR schedule on K3's inputs, held to K3's result and
    # to the plain result K3 was held to in every case, and to its own plain
    # version once per schedule (the plain datapath without peaks), both
    # timed in this call
    for lift in (1, 2):
        for src, (feed, state, cfg, time2, want_k3, k3_ms,
                  want_plain) in k3.items():
            label = f"{src} twopass {lift}"

            def run(feed=feed, state=state, cfg=cfg, time2=time2,
                    lift=lift):
                return tpg.launch_kernel(feed, state, cfg, TC, K, time2,
                                         fir_twopass=lift)
            got = run()
            torch.cuda.synchronize()
            err = max(check_equal(f"{label} vs K3", got, want_k3),
                      check_equal(f"{label} vs K3's plain", got, want_plain))
            plain_ms = None
            if src == "FIR plain":
                t0 = time.perf_counter()
                want = tpg.process_window_twopass_plain(feed, state, cfg, TC,
                                                        K, lift, time2)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = max(err, check_equal(label, got, want))
            what = check_strong(label, got)
            ms = time_kernel(run, 20, flush)
            print(f"  K5 {label}: bit-equal to K3 and its plain result"
                  + (" and to K5's plain version" if plain_ms else "")
                  + f" ({what}); kernel {ms:.4f} ms/batch, K3 {k3_ms:.4f} "
                  "ms/batch in this call"
                  + (f", plain {plain_ms:.1f} ms/batch" if plain_ms else ""),
                  flush=True)
            record("K5", label, err, ms, plain_ms,
                   kernel_work(feed, cfg, "time2" if time2 else "plain",
                               T_APA, C_APA), base=("K3", k3_ms))
    variant_kernels(dev, plain, case_ms, k3, k4, flush, record, reported)
    return out


def check_variant(kern, label, run, wants, plain_fn, base, work, flush,
                  record, reported):
    """One case of a kernel variant: its result bit-equal to each of
    ``wants`` (label -> result: the kernel it varies, or that kernel's
    plain result on the same samples) and, for the reported case, to its
    own plain version (``plain_fn``); timed beside the kernel it varies
    (``base`` = (name, ms) from this call)."""
    got = run()
    torch.cuda.synchronize()
    err = 0
    for what, want in wants.items():
        err = max(err, check_equal(f"{label} vs {what}", got, want))
    plain_ms = None
    if label == reported[kern]:
        t0 = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, check_equal(label, got, want))
    info = check_strong(label, got)
    ms = time_kernel(run, 20, flush)
    print(f"  {kern} {label}: bit-equal to " + ", ".join(wants)
          + (" and to its plain version" if plain_ms else "")
          + f" ({info}); kernel {ms:.4f} ms/batch, {base[0]} {base[1]:.4f} "
          "ms/batch in this call"
          + (f", plain {plain_ms:.1f} ms/batch" if plain_ms else ""),
          flush=True)
    record(kern, label, err, ms, plain_ms, work, base=base,
           case=(run, want) if plain_ms else None)


def k3b_cases(k3, k4, flush, record):
    """Phase 3, K3b (``fir_packed``: K3's mode of the pipeline with the
    packed front and back) on every feed K3's mode takes at APA width:
    K3's plain rows (peaks off and on) and time2 rows, K4's frame words and
    words14 rows (K4's decode, the gather and the slab), and the slab again
    at tc = 1024, a chunk whose time2 words of 128 channels would not fit a
    block's shared memory.  Each case is bit-equal to K3's mode on the same
    feed and options and to its own plain version, and is timed in turns
    with K3's mode (K3b, K3, K3b, K3; 10 launches each)."""
    _, state, cfg, *_ = k3["FIR plain"]
    w14 = k4["FIR words14"][0]
    words14 = dict(time_packed=False, packed14="words14")
    cases = [(src, feed, st, c, TC, dict(time_packed=t2))
             for src, (feed, st, c, t2, *_) in k3.items()] + [
        ("FIR frames", k4["FIR frames"][0], state, cfg, TC,
         dict(time_packed=False, packed14="frames")),
        ("FIR words14", w14, state, cfg, TC, words14),
        ("FIR words14 gather", w14, state, cfg, TC,
         dict(words14, words14_gather=True)),
        ("FIR words14 slab", w14, state, cfg, TC,
         dict(words14, words14_slab=True)),
        ("FIR words14 slab tc=1024", w14, state, cfg, 1024,
         dict(words14, words14_slab=True))]
    for src, feed, st, c, tc, kw in cases:
        label = f"{src} fir_packed"

        def run(feed=feed, st=st, c=c, tc=tc, kw=kw):
            return tpg.launch_kernel(feed, st, c, tc, K, fir_packed=True,
                                     **kw)

        def k3_run(feed=feed, st=st, c=c, tc=tc, kw=kw):
            return tpg.launch_kernel(feed, st, c, tc, K, **kw)
        got, want_k3 = run(), k3_run()
        t0 = time.perf_counter()
        want = tpg.process_window_plain(feed, st, c, tc, K, fir_packed=True,
                                        **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(check_equal(f"{label} vs K3's mode", got, want_k3),
                  check_equal(label, got, want))
        info = check_strong(label, got)
        turns = [time_kernel(fn, 10, flush) for fn in (run, k3_run) * 2]
        ms, k3_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        print(f"  K3b {label}: bit-equal to K3's mode on the same feed and "
              f"to its plain version ({info}); K3b {ms:.4f} ms/batch, K3 "
              f"{k3_ms:.4f} ms/batch in turns in this call (x"
              f"{ms / k3_ms:.4f}), plain {plain_ms:.1f} ms/batch",
              flush=True)
        decode = "packed14" if "packed14" in kw else \
            "time2" if kw["time_packed"] else "plain"
        record("K3b", label, err, ms, plain_ms,
               kernel_work(feed, c, decode, T_APA, C_APA),
               base=("K3", k3_ms), case=(run, want))


def variant_kernels(dev, plain, case_ms, k3, k4, flush, record, reported):
    """Phase 3, the variants of _tpg_kernel on the inputs above: K3b (the
    SWAR carry) on K3's and K4's feeds (``k3b_cases``); K2b on the same
    ADCs as int16, held to K2's (K3's) plain result (14-bit streams stay in
    int16 range); K4b-slab (four families) and K4b-gather (AbsRS, FIR) on
    K4's words14 rows, held to the plain result K4 was held to.  Each is
    held to its own plain version once and timed beside the kernel it
    varies."""
    k3b_cases(k3, k4, flush, record)
    for fam in ("SimpleThreshold", "AbsRS", "StandardRS", "FIR"):
        a, cfg, state, want = plain[f"{fam} plain"]
        feed16 = torch.from_numpy(a.astype(np.int16)).to(dev)
        state16 = state.to(torch.int16)
        if not torch.equal(state16.to(torch.int32), state):
            raise AssertionError(f"{fam}: the seeded state leaves int16")
        want16 = tuple(want[:2]) + (want[2].to(torch.int16),)
        base = "K3" if fam == "FIR" else "K2"
        check_variant(
            "K2b", f"{fam} int16",
            lambda feed16=feed16, state16=state16, cfg=cfg:
                tpg.launch_kernel(feed16, state16, cfg, TC, K, False),
            {f"{base} plain": want16},
            lambda feed16=feed16, state16=state16, cfg=cfg:
                tpg.process_window_plain(feed16, state16, cfg, TC, K, False),
            (f"{base} plain datapath", case_ms[f"{fam} plain"]),
            kernel_work(feed16, cfg, "plain", T_APA, C_APA), flush, record,
            reported)
        w14, k4_ms = k4[f"{fam} words14"]
        for sched in ("slab", "gather"):
            if sched == "gather" and fam not in ("AbsRS", "FIR"):
                continue
            opt = {f"words14_{sched}": True}
            check_variant(
                f"K4b-{sched}", f"{fam} words14 {sched}",
                lambda w14=w14, state=state, cfg=cfg, opt=opt:
                    tpg.launch_kernel(w14, state, cfg, TC, K, False,
                                      "words14", **opt),
                {"K4 (plain)": want},
                lambda w14=w14, state=state, cfg=cfg, opt=opt:
                    tpg.process_window_plain(w14, state, cfg, TC, K, False,
                                             "words14", **opt),
                ("K4 words14", k4_ms),
                kernel_work(w14, cfg, "packed14", T_APA, C_APA),
                flush, record, reported)


def bound(work: dict, sm_mhz: float, measured_gops: float):
    """(bound_ms, bound_by) of a kernel case's bytes and operations, the
    operations over the int32 rate the issue probe sustained in this run
    (``roofline.bound_ms``)."""
    bytes_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = roofline.bound_ms(work["ops"], sm_mhz, measured_gops)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def clock(fn):
    """(fn(), ms) with the device synced at the end."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def apa_stage_split(app, frames, feed: str, n_rep: int = 5):
    """One batch through the app's device seam one step at a time, each
    ended by a device sync: median ms per stage.  The app's carried state
    is left untouched."""
    L, N, _ = frames.shape
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    tc = tpg.auto_tc(T, cap=kernel_knobs(app.cfg)["tc"])
    reps = []
    for _ in range(n_rep):
        r = {}
        words = None
        if feed != "time2":   # the time2 codec reads the frames in place
            words, r["words copy"] = clock(lambda: wibeth.frames_bytes_to_u32(
                frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(L, T, 28))
        # the app's own host stage (a view for the fused and packed feeds)
        (host, _), r["codec"] = clock(lambda: app._host_feed(frames, words))
        dev_in, r["H2D"] = clock(lambda: torch.from_numpy(host).to(
            app.device))
        if feed == "time2":
            kw = dict(feed=dev_in.reshape(T // 2, -1), time_packed=True)
        elif feed == "packed":
            kw = dict(time_packed=False)
            kw["feed"], r["device unpack"] = clock(
                lambda: wibeth.unpack_frames(dev_in.transpose(0, 1))
                .reshape(T, C))
        else:
            kw = dict(feed=dev_in, time_packed=False,
                      packed14="frames" if feed == "fused" else "words14")
        (slots, nclose, _), r["kernel"] = clock(lambda: tpg.process_window(
            state=app._state, cfg=app.cfg, tc=tc, k_slots=app.k_slots, **kw))
        packed, r["compaction"] = clock(lambda: compact_on_device(
            slots, nclose, 0, C, max(2048, 2 * C)))
        _, r["fetch"] = clock(lambda: unpack_compact(packed))
        reps.append(r)
    return {k: statistics.median(r[k] for r in reps) for k in reps[0]}


def apa_slice(dev) -> tuple:
    """Phase 4.  Returns each feed's kernel launches in its app run, and
    for phase 10 its batches, memory factors, configuration and plain
    result."""
    rng = np.random.default_rng(SEED)
    ts, batches, checked_adcs = 0x1000000, [], []
    for b in range(N_WARM + N_TIMED):
        frames, adcs_b = make_batch(rng, N_LINKS, FRAMES, b, ts)
        batches.append(frames)
        if b < N_CHECKED:     # (L, N, 64 ticks, 64 ch) -> (T, C)
            checked_adcs.append(
                (adcs_b & 0x3FFF).transpose(1, 2, 0, 3)
                .reshape(FRAMES * 64, C_APA).astype(np.int32))
        ts += FRAMES * 2048
    data_seconds = N_TIMED * FRAMES * 64 * 32 / 62.5e6
    plain = None
    launches_of, summary = {}, {}
    for feed, (flags, kern) in APP_FEEDS.items():
        app = APAReadoutApp(n_links=N_LINKS, algorithm="AbsRS", threshold=150,
                            threshold_on_collection=True, device=dev,
                            **flags)
        fetched = []
        fetch = app._fetch_hits

        def recording_fetch(packed, fetch=fetch, fetched=fetched):
            out = fetch(packed)
            fetched.append(out)
            return out

        app._fetch_hits = recording_fetch
        tpg.reset_launches()
        t0 = time.perf_counter()
        for frames in batches[:N_WARM]:
            app.process_batch(frames)
        warm_s = time.perf_counter() - t0
        app.batch_timings.clear()     # latency_info: steady batches only
        t0 = time.perf_counter()
        for frames in batches[N_WARM:]:
            app.process_batch(frames)
        app.flush()
        wall = time.perf_counter() - t0
        launches = dict(tpg.process_window.kernel_launches)
        tally()
        info = app.get_info()
        lat = app.latency_info(frames_per_batch=FRAMES)
        rtf = data_seconds / wall
        print(f"  {feed} feed: warm-up {N_WARM} batch in {warm_s:.4f} s "
              f"(set-up, not in the RTF); steady wall {wall:.4f} s for "
              f"{N_TIMED} batches, data {data_seconds:.6f} s, "
              f"end_to_end_rtf {rtf:.4f}")
        print(f"  {feed} feed info:", json.dumps({k: info[k] for k in (
            "total_hits", "total_tps_sent", "ts_errors", "hits_dropped",
            "tpsets_queued", "raw_buffered", "words_copy_bytes")}),
            "launches",
            json.dumps(launches))
        print(f"  {feed} feed latency_info:", json.dumps(lat))
        want = {k: 0 for k in launches}
        want[kern] = N_WARM + N_TIMED
        if launches != want:
            raise AssertionError(f"{feed} feed: launches {launches}, want "
                                 f"{want}")
        if not (info["total_hits"] > 0 and info["ts_errors"] == 0
                and info["tpsets_queued"] > 0):
            raise AssertionError(f"{feed} feed: slice output wrong: {info}")
        # the time2 feed makes no words copy; the others copy L x N x 7168
        # bytes a batch
        copied = 0 if feed == "time2" else \
            len(batches) * N_LINKS * FRAMES * wibeth.N_TIME_SAMPLES * 28 * 4
        if info["words_copy_bytes"] != copied:
            raise AssertionError(f"{feed} feed: words_copy_bytes "
                                 f"{info['words_copy_bytes']}, want {copied}")
        if plain is None:
            # one plain result for every feed: the same frames give the
            # same function
            rmf = np.concatenate([p.register_memory_factor
                                  for p in app.procs])
            plain = list(plain_app_hits(checked_adcs, rmf, app.cfg,
                                        app.k_slots, dev))
            apa_data = {"batches": batches, "plain": plain, "rmf": rmf,
                        "cfg": app.cfg}
        for b, (want_h, d_want) in enumerate(plain):
            hits, d = fetched[b]
            if d != d_want or not np.array_equal(hits, want_h):
                raise AssertionError(
                    f"{feed} feed batch {b}: app hits ({len(hits)}, dropped "
                    f"{d}) differ from the plain version ({len(want_h)}, "
                    f"dropped {d_want})")
            print(f"  {feed} feed batch {b}: {len(hits)} hits, {d} dropped "
                  "== plain")
        split = apa_stage_split(app, batches[-1], feed)
        print(f"  {feed} feed stage split, one batch, ms (medians of 5, each "
              "stage synced):",
              json.dumps({k: round(v, 4) for k, v in split.items()}))
        launches_of[feed] = launches[kern]
        summary[feed] = {"end_to_end_rtf": round(rtf, 4),
                         "proc_ms_p50": lat["proc_ms_p50"],
                         "proc_ms_p95": lat["proc_ms_p95"]}
    print("  apa feeds:", json.dumps(summary))
    return launches_of, apa_data


def make_wib2_procs(time2: bool, dev):
    procs, sinks = [], []
    for link in range(WIB2_LINKS):
        sink = QueueSender()
        p = WIB2FrameProcessor(tp_sink=sink, device=dev)
        p.conf({"source_id": link, "crate_id": 1, "slot_id": 0,
                "link_id": link, "enable_tpg": True, "tpg_algorithm": "FIR",
                "tpg_threshold": 5, "tp_timeout": 100_000,
                "tpg_time2_feed": time2})
        p.start()
        procs.append(p)
        sinks.append(sink)
    return procs, sinks


def wib2_stage_split(procs, superchunks, time2: bool, n_rep: int = 5):
    """One batch of every link through the processor's steps one at a
    time, each ended by a device sync: median ms per stage, summed over
    the links.  The processors' carried state is left untouched."""
    stages = {}
    for l, p in enumerate(procs):
        C = p.N_CHANNELS
        frames = wib2.superchunk_frames(superchunks[l])
        tc = tpg.auto_tc(WIB2_T, cap=kernel_knobs(p.tpg_cfg)["tc"])
        reps = []
        for _ in range(n_rep):
            r = {}
            words, r["host words"] = clock(lambda: np.ascontiguousarray(
                wib2.adc_region_u32(frames)).reshape(1, -1, wib2.ADC_WORDS))
            if time2:
                host, r["host codec"] = clock(lambda: p._host_time2(words))
                feed, r["H2D"] = clock(lambda: torch.from_numpy(host).to(
                    p.device).reshape(WIB2_T // 2, C))
            else:
                dw, r["H2D"] = clock(lambda: p._device_words(words))
                feed, r["unpack"] = clock(lambda: wib2.unpack_frames(
                    dw.transpose(0, 1)).reshape(WIB2_T, C))
            (slots, nclose, _), r["kernel"] = clock(
                lambda: tpg.process_window(feed, p._dev_state, p.tpg_cfg,
                                           tc, p.k_slots, time2))
            packed, r["compaction"] = clock(lambda: compact_on_device(
                slots, nclose, 0, C, max(2048, 2 * C)))
            (hits, _), r["fetch"] = clock(lambda: unpack_compact(packed))
            _, r["TP tail"] = clock(lambda: p.process_swtpg_hits(
                hits, int(wib2.get_timestamp(frames[0, :1])[0])))
            reps.append(r)
        for k in reps[0]:
            stages[k] = stages.get(k, 0.0) + statistics.median(
                r[k] for r in reps)
    return stages


def wib2_slice(time2: bool, batches, checked, plain: list, dev):
    """Phase 5, one ingest mode.  ``plain`` holds the plain result of the
    checked batches, made by the first mode's call on the plain datapath
    (the time2 feed carries the same samples, so the same result).
    Returns the kernel launch counts of the processors' run."""
    mode = "time2 feed" if time2 else "packed ingest"
    procs, sinks = make_wib2_procs(time2, dev)
    fetched = [[None] * WIB2_LINKS for _ in range(N_CHECKED)]
    batch_idx = [0]
    for l, p in enumerate(procs):
        def recording(hits, timestamp, p=p, l=l, orig=p.process_swtpg_hits):
            b = batch_idx[0]
            if b < N_CHECKED:
                fetched[b][l] = (hits, p.metrics.count("num_hits_dropped"))
            return orig(hits, timestamp)
        p.process_swtpg_hits = recording
    n_tps = 0
    batch_ms = []
    tpg.reset_launches()
    t_all = time.perf_counter()
    for b, sc in enumerate(batches):
        batch_idx[0] = b
        t0 = time.perf_counter()
        for l, p in enumerate(procs):
            p.process(sc[l])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if b == 0:
            t_steady = time.perf_counter()
        for s in sinks:
            n_tps += sum(len(x) for x in s.drain())
    wall = time.perf_counter() - t_steady
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    wall_all = time.perf_counter() - t_all
    n_b = len(batches)
    want = {k: 0 for k in KERNELS}
    want["K2"] = 0 if time2 else n_b * WIB2_LINKS
    want["K3"] = n_b * WIB2_LINKS
    data_s = WIB2_TIMED * WIB2_T * WIB2_TICK_S
    steady = batch_ms[1:]
    print(f"  {mode}: warm-up batch {batch_ms[0]:.3f} ms (set-up, not in the "
          f"RTF); steady wall {wall:.4f} s for {WIB2_TIMED} batches, data "
          f"{data_s:.6f} s, end_to_end_rtf {data_s / wall:.4f}; ms/batch "
          f"p50 {statistics.median(steady):.3f} min {min(steady):.3f} max "
          f"{max(steady):.3f} ({wall_all:.3f} s with the warm-up)")
    metrics = {k: sum(p.metrics.count(k) for p in procs) for k in (
        "num_hits", "num_hits_dropped", "num_tps_sent", "num_ts_errors")}
    print(f"  {mode}: {json.dumps(metrics)}, TPs drained {n_tps}, launches "
          f"{json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"{mode}: launches {launches}, want {want}")
    if not (metrics["num_tps_sent"] > 0 and n_tps > 0
            and metrics["num_ts_errors"] == 0):
        raise AssertionError(f"{mode}: slice output wrong: {metrics}")
    prev_drop = [0] * WIB2_LINKS
    if not plain:
        plain.extend(plain_processor_hits(checked, procs, dev))
    for b, want_links in enumerate(plain):
        n_h = n_d = 0
        for l, (want_h, want_d) in enumerate(want_links):
            hits, drop_total = fetched[b][l]
            d = drop_total - prev_drop[l]
            prev_drop[l] = drop_total
            if d != want_d or not np.array_equal(hits, want_h):
                raise AssertionError(
                    f"{mode} batch {b} link {l}: hits ({len(hits)}, dropped "
                    f"{d}) differ from the plain version ({len(want_h)}, "
                    f"dropped {want_d})")
            n_h += len(hits)
            n_d += d
        print(f"  {mode} batch {b}: {n_h} hits, {n_d} dropped over "
              f"{WIB2_LINKS} links == plain")
    split = wib2_stage_split(procs, batches[-1], time2)
    print(f"  {mode} stage split, one batch of {WIB2_LINKS} links, ms "
          "(medians of 5, each stage synced):",
          json.dumps({k: round(v, 4) for k, v in split.items()}))
    return launches


def make_protowib_procs(time2: bool, dev):
    procs = []
    for link in range(PW_LINKS):
        # the handler drops a TP older than tp_timeout clocks at insert: a
        # batch spans PW_T * 25 clocks, so every TP of a batch is kept
        handler = WIBTPHandler(tp_timeout=2 * PW_T * 25, source_id=link)
        p = WIBFrameProcessor(tp_handler=handler, device=dev)
        p.conf({"crate_id": 1, "slot_id": 0, "link_id": link,
                "enable_tpg": True, "tpg_backend": "pallas",
                "tpg_collection_threshold": 5, "tpg_induction_threshold": 5,
                "tpg_time2_feed": time2})
        p.start()
        procs.append(p)
    return procs


def plain_protowib_hits(adcs_batches, p0, dev):
    """What the per-link ProtoWIB processors must fetch for consecutive
    batches of (L, T, 256) ADCs: per plane, the kernel's plain version (the
    fused FIR tick; K5 is held equal to it) over that plane's channels of
    all links at once, with the processors' seeding, tc, K and compaction
    per link, carrying state.  Yields per batch {plane: [(hits, dropped)
    per link]}; ``p0`` is one of the processors, after its run."""
    L = adcs_batches[0].shape[0]
    cfgs = {"collection": p0.coll_cfg, "induction": p0.ind_cfg}
    states = {}
    for adcs in adcs_batches:
        T = adcs.shape[1]
        tc = tpg.auto_tc(T, cap=kernel_knobs(p0.coll_cfg)["tc"])
        out = {}
        for plane, idx in PW_PLANES:
            C = len(idx)
            flat = np.ascontiguousarray(
                adcs[:, :, idx].transpose(1, 0, 2).reshape(T, L * C))
            if plane not in states:
                states[plane] = tpg.pack_state(seed_chanstate(
                    init_chanstate(L * C), flat[0], 0), L * C, device=dev)
            slots, nclose, states[plane] = tpg.process_window_plain(
                torch.from_numpy(flat).to(dev), states[plane], cfgs[plane],
                tc, p0.k_slots, time_packed=False)
            out[plane] = [unpack_compact(compact_on_device(
                slots[..., l * C:(l + 1) * C].contiguous(),
                nclose[:, l * C:(l + 1) * C].contiguous(), 0, C,
                max(2048, 2 * C))) for l in range(L)]
        yield out


def protowib_stage_split(procs, superchunks, time2: bool, n_rep: int = 5):
    """One batch of every link through the processor's device seam one
    step at a time, each ended by a device sync: median ms per stage,
    summed over the links (and the two planes).  The processors' carried
    state is left untouched; the TP tail feeds their handlers once more."""
    stages = {}
    for l, p in enumerate(procs):
        flat = protowib.superchunk_frames(superchunks[l]) \
            .reshape(-1, protowib.FRAME_SIZE)
        knobs = kernel_knobs(p.coll_cfg)
        tc = tpg.auto_tc(PW_T, cap=knobs["tc"])
        stacks = {"collection": (p._coll_stack, p.coll_cfg),
                  "induction": (p._ind_stack, p.ind_cfg)}
        reps = []
        for _ in range(n_rep):
            r = {}
            feeds = {}
            if time2:
                r["host codec"] = r["H2D"] = 0.0
                for plane, idx in PW_PLANES:
                    host, ms = clock(lambda: native.relayout_time2_protowib(
                        flat, idx, pad8=False))
                    r["host codec"] += ms
                    feeds[plane], ms = clock(lambda: torch.from_numpy(
                        host).to(p.device).reshape(PW_T // 2, -1))
                    r["H2D"] += ms
            else:
                words, r["words + H2D"] = clock(lambda: p._device_words(flat))
                adcs, r["device decode"] = clock(
                    lambda: protowib.unpack_frames(words))
                r["plane gather"] = 0.0
                for plane, idx in PW_PLANES:
                    feeds[plane], ms = clock(lambda: adcs.index_select(
                        1, torch.as_tensor(idx, device=adcs.device)))
                    r["plane gather"] += ms
            r["kernel"] = r["compaction"] = r["fetch"] = 0.0
            hits = {}
            for plane, idx in PW_PLANES:
                state, cfg = stacks[plane]
                (slots, nclose, _), ms = clock(lambda: tpg.process_window(
                    feeds[plane], state, cfg, tc, p.k_slots, time2,
                    fir_twopass=knobs["fir_twopass"]))
                r["kernel"] += ms
                packed, ms = clock(lambda: compact_on_device(
                    slots, nclose, 0, len(idx), max(2048, 2 * len(idx))))
                r["compaction"] += ms
                (hits[plane], _), ms = clock(lambda: unpack_compact(packed))
                r["fetch"] += ms
            ts = int(protowib.get_timestamp(flat[:1])[0])
            _, r["TP tail"] = clock(lambda: (
                p._emit_tps(hits["collection"], p.collection_offlines, ts),
                p._emit_tps(hits["induction"], p.induction_offlines, ts)))
            reps.append(r)
        for k in reps[0]:
            stages[k] = stages.get(k, 0.0) + statistics.median(
                r[k] for r in reps)
    return stages


def protowib_run(label: str, time2: bool, twopass: int, batches, checked,
                 plain: list, dev):
    """Phase 6, one run: the processors under a tuned file naming
    ``twopass``; ``plain`` holds the plain result of the checked batches,
    made after the first run.  Returns (the kernel launch counts of the
    run, its hits and TP counters)."""
    tuned = _build.BUILD_DIR / f"tuned_fir_twopass{twopass}.json"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    tuned.write_text(json.dumps({"FIR": {"twopass": twopass}}))
    os.environ["FDREADOUT_TUNED"] = str(tuned)
    try:
        procs = make_protowib_procs(time2, dev)
        if kernel_knobs(TPGConfig.from_raw("FIR", threshold=5))[
                "fir_twopass"] != twopass:
            raise AssertionError(f"{label}: the tuned file was not read")
        fetched = [[None] * PW_LINKS for _ in range(N_CHECKED)]
        batch_idx = [0]
        for l, p in enumerate(procs):
            def recording(hits, offlines, timestamp, p=p, l=l,
                          orig=p._emit_tps):
                b = batch_idx[0]
                if b < N_CHECKED:
                    fetched[b][l] = (fetched[b][l] or ()) + (hits,)
                return orig(hits, offlines, timestamp)
            p._emit_tps = recording
        drops = [[0] * PW_LINKS for _ in range(N_CHECKED + 1)]
        batch_ms = []
        tpg.reset_launches()
        t_all = time.perf_counter()
        for b, sc in enumerate(batches):
            batch_idx[0] = b
            t0 = time.perf_counter()
            for p, sc_l in zip(procs, sc):
                p.process(sc_l)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            if b == 0:
                t_steady = time.perf_counter()
            if b < N_CHECKED:
                drops[b + 1] = [p.metrics.count("num_hits_dropped")
                                for p in procs]
        wall = time.perf_counter() - t_steady
        launches = dict(tpg.process_window.kernel_launches)
        tally()
        wall_all = time.perf_counter() - t_all
        n_launch = len(batches) * PW_LINKS * len(PW_PLANES)
        want = {k: 0 for k in KERNELS}
        if twopass:
            want["K5"] = n_launch
        else:
            want["K3"] = n_launch
            want["K2"] = 0 if time2 else n_launch
        data_s = PW_TIMED * PW_T * PW_TICK_S
        steady = batch_ms[1:]
        print(f"  {label}: warm-up batch {batch_ms[0]:.3f} ms (set-up, not "
              f"in the RTF); steady wall {wall:.4f} s for {PW_TIMED} "
              f"batches, data {data_s:.6f} s, end_to_end_rtf "
              f"{data_s / wall:.4f}; ms/batch p50 "
              f"{statistics.median(steady):.3f} min {min(steady):.3f} max "
              f"{max(steady):.3f} ({wall_all:.3f} s with the warm-up)")
        metrics = {k: sum(p.metrics.count(k) for p in procs) for k in (
            "num_hits", "num_hits_dropped", "num_tps_sent", "num_ts_errors")}
        for p in procs:        # the windows still open at the end
            while p.tp_handler.try_sending_tpsets(1 << 62) is not None:
                pass
        tpsets = sum(p.tp_handler.sent_tpsets for p in procs)
        print(f"  {label}: {json.dumps(metrics)}, TPSets sent {tpsets}, "
              f"launches {json.dumps(launches)}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want {want}")
        if not (metrics["num_tps_sent"] > 0 and tpsets > 0
                and metrics["num_ts_errors"] == 0):
            raise AssertionError(f"{label}: slice output wrong: {metrics}")
        if not plain:
            plain.extend(plain_protowib_hits(checked, procs[0], dev))
        for b, want_planes in enumerate(plain):
            n_h = n_d = 0
            for l in range(PW_LINKS):
                got = fetched[b][l]
                d = drops[b + 1][l] - drops[b][l]
                want_d = 0
                for (plane, _), hits in zip(PW_PLANES, got):
                    want_h, dp = want_planes[plane][l]
                    want_d += dp
                    if not np.array_equal(hits, want_h):
                        raise AssertionError(
                            f"{label} batch {b} link {l} {plane}: "
                            f"{len(hits)} hits differ from the plain "
                            f"version's {len(want_h)}")
                    n_h += len(hits)
                if d != want_d:
                    raise AssertionError(f"{label} batch {b} link {l}: "
                                         f"dropped {d}, plain {want_d}")
                n_d += d
            print(f"  {label} batch {b}: {n_h} hits, {n_d} dropped over "
                  f"{PW_LINKS} links x 2 planes == plain")
        split = protowib_stage_split(procs, batches[-1], time2)
        print(f"  {label} stage split, one batch of {PW_LINKS} links, ms "
              "(medians of 5, each stage synced):",
              json.dumps({k: round(v, 4) for k, v in split.items()}))
        return launches, metrics
    finally:
        os.environ.pop("FDREADOUT_TUNED", None)


def protowib_slice(dev) -> dict:
    """Phase 6.  Returns the summed kernel launch counts of the three
    runs."""
    t0 = time.perf_counter()
    batches, checked = [], []
    for b in range(1 + PW_TIMED):
        sc, adcs = protowib_superchunks(
            PW_LINKS, PW_SC, seed=SEED + 100 + b,
            ts0=0x1000000 + b * PW_SC * protowib.SUPERCHUNK_TICK_DIFFERENCE)
        batches.append(sc)
        if b < N_CHECKED:
            checked.append(adcs)
    print(f"  data: {len(batches)} batches of {PW_LINKS} x {PW_SC} "
          f"superchunks in {time.perf_counter() - t0:.3f} s")
    plain = []
    totals = {k: 0 for k in KERNELS}
    first = None
    for label, time2, twopass in PW_RUNS:
        launches, metrics = protowib_run(label, time2, twopass, batches,
                                         checked, plain, dev)
        for k in KERNELS:
            totals[k] += launches[k]
        if first is None:
            first = metrics
        elif metrics != first:
            raise AssertionError(f"{label}: {metrics} differ from the first "
                                 f"run's {first}")
    return totals


ENTRY_WINDOWS = 8
ENTRY_TICK_S = 32 / 62.5e6   # 512 ns per WIBEth tick


def kernel_entries(dev) -> dict:
    """Phase 7: the entries that reach the variants of _tpg_kernel, at APA
    width (2560 channels) over ENTRY_WINDOWS windows of 8192 ticks carrying
    state, each window copied to the card, run, compacted on the device
    (``compact_on_device``) and fetched (``unpack_compact``).  The hits of
    windows 0-1 equal the plain version's: one AbsRS plain result (the slab
    entry's plain version) serves the three AbsRS entries, which compute
    the same function of the same samples (their unpack is checked equal
    to the ADCs; K2b's int16 arithmetic equals K2's on 14-bit streams, as
    phase 3 holds).  Returns the kernel launch counts of the four runs."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    ts = 0x1000000
    w14, a32, a16 = [], [], []
    for b in range(ENTRY_WINDOWS):
        frames, adcs_b = make_batch(rng, N_LINKS, FRAMES, b, ts)
        ts += FRAMES * 2048
        words = wibeth.frames_bytes_to_u32(
            frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(N_LINKS, T_APA, 28)
        w14.append(native.relayout_words14(words))
        a = (adcs_b & 0x3FFF).transpose(1, 2, 0, 3).reshape(
            T_APA, C_APA).astype(np.int32)
        a32.append(a)
        a16.append(a.astype(np.int16))
    checked = a32[:N_CHECKED]
    if not torch.equal(wibeth.unpack_words14(torch.from_numpy(w14[0]),
                                             C_APA),
                       torch.from_numpy(checked[0])):
        raise AssertionError("the words14 rows do not unpack to the ADCs")
    print(f"  data: {ENTRY_WINDOWS} windows of {N_LINKS} links x {FRAMES} "
          f"frames in {time.perf_counter() - t0:.3f} s")
    absrs = TPGConfig.from_raw("AbsRS", threshold=150)
    fir = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    rmf = absrs.rs_memory_factor_x10

    def seeded(cfg, dtype=torch.int32):
        return tpg.pack_state(seed_chanstate(
            init_chanstate(C_APA), checked[0][0],
            rmf if cfg is absrs else 0), C_APA, device=dev, dtype=dtype)

    def hits_of(out, b):
        slots, nclose, _ = out
        return unpack_compact(compact_on_device(
            slots, nclose, b * T_APA, C_APA, max(2048, 2 * C_APA)))

    # (label, cfg, state dtype, host feed of window b, run, launches)
    entries = (
        ("process_words14_feed(slab=True)", absrs, torch.int32, w14.__getitem__,
         lambda f, st, tc: ingest.process_words14_feed(
             f, st, absrs, C_APA, tc=tc, k_slots=K, slab=True),
         {"K4b-slab": 1}),
        ("process_window(words14, words14_gather=True)", absrs, torch.int32,
         w14.__getitem__,
         lambda f, st, tc: tpg.process_window(
             f, st, absrs, tc, K, time_packed=False, packed14="words14",
             words14_gather=True),
         {"K4b-gather": 1}),
        ("process_window(int16 samples)", absrs, torch.int16,
         a16.__getitem__,
         lambda f, st, tc: tpg.process_window(f, st, absrs, tc, K,
                                              time_packed=False),
         {"K2b": 1}),
        ("process_window(fir_packed=True)", fir, torch.int32,
         a32.__getitem__,
         lambda f, st, tc: tpg.process_window(f, st, fir, tc, K,
                                              time_packed=False,
                                              fir_packed=True),
         {"K2": 1, "K3b": 1}))
    plain = {}
    totals = {k: 0 for k in KERNELS}
    summary = {}
    for label, cfg, dtype, host, run, per_window in entries:
        tc = kernel_knobs(cfg)["tc"]
        state = seeded(cfg, dtype)
        fetched, ms = [], []
        tpg.reset_launches()
        for b in range(ENTRY_WINDOWS):
            t1 = time.perf_counter()
            feed = torch.from_numpy(host(b)).to(dev)
            out = run(feed, state, tc)
            state = out[2]
            got = hits_of(out, b)
            ms.append((time.perf_counter() - t1) * 1e3)
            if b < N_CHECKED:
                fetched.append(got)
        launches = dict(tpg.process_window.kernel_launches)
        tally()
        want = {k: n * ENTRY_WINDOWS if k in per_window else 0
                for k, n in {**launches, **per_window}.items()}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want {want}")
        for k in KERNELS:
            totals[k] += launches[k]
        key = "FIR" if cfg is fir else "AbsRS"
        if key not in plain:
            p_state, plain[key] = seeded(cfg), []
            for b, a in enumerate(checked):
                if cfg is fir:
                    out = tpg.process_window_plain(
                        torch.from_numpy(a).to(dev), p_state, fir, tc, K,
                        False, fir_packed=True)
                else:
                    out = tpg.process_window_plain(
                        torch.from_numpy(w14[b]).to(dev), p_state, absrs, tc,
                        K, False, "words14", words14_slab=True)
                p_state = out[2]
                plain[key].append(hits_of(out, b))
        for b, ((h, d), (wh, wd)) in enumerate(zip(fetched, plain[key])):
            if d != wd or not np.array_equal(h, wh):
                raise AssertionError(
                    f"{label} window {b}: hits ({len(h)}, dropped {d}) "
                    f"differ from the plain version ({len(wh)}, dropped "
                    f"{wd})")
        steady = ms[1:]
        rtf = len(steady) * T_APA * ENTRY_TICK_S / (sum(steady) / 1e3)
        n_hits = [len(h) for h, _ in fetched]
        print(f"  {label}: window 0 {ms[0]:.3f} ms (set-up); steady "
              f"{len(steady)} windows ms p50 {statistics.median(steady):.3f} "
              f"min {min(steady):.3f} max {max(steady):.3f}, RTF {rtf:.4f}; "
              f"hits of windows 0-1 {n_hits} == plain; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}",
              flush=True)
        summary[label] = {"ms_p50": statistics.median(steady),
                          "rtf": round(rtf, 4)}
    print("  kernel entries:", json.dumps(summary))
    return totals


def carry_registers(kernels: dict) -> dict:
    """``ptxas -v`` of the fused ticks, the carry layout against the direct
    store: {family (" pipeline" for pipe_kernel's K2, K3 and K4): {"direct":
    [min, max registers], "carry": [min, max], "carry_spill_B": max}} over
    the encodings and variants; K5 and the staged arms have the direct
    store only."""
    fam = {"ThresholdChannelILi0": "SimpleThreshold",
           "ThresholdChannelILi1": "AbsRS",
           "ThresholdChannelILi2": "StandardRS", "10FirChannel": "FIR",
           "16FirPackedChannel": "FIR fir_packed"}
    out = {}
    for name, (regs, spill) in kernels.items():
        mp = _PIPE.search(name)
        if mp is not None and mp.group(2) not in ("1", "4"):
            continue
        m = _CARRY.search(name)
        if m is None:
            continue
        arm = "carry" if m.group(1) == "1" else "direct"
        for pat, family in fam.items():
            if pat in name:
                key = family + (" pipeline" if mp is not None else "")
                o = out.setdefault(key, {"direct": [999, 0],
                                         "carry": [999, 0],
                                         "carry_spill_B": 0})
                o[arm] = [min(o[arm][0], regs), max(o[arm][1], regs)]
                if arm == "carry":
                    o["carry_spill_B"] = max(o["carry_spill_B"], spill)
    return out


# int32 operations per element and step of P2's mix (sub, shift, xor, and,
# add) and per channel and tick of P3's chain (sub, clip as min and max, add,
# two compares, three selects)
MIX_OPS, FRUGAL_OPS = 5, 9


def pipeline_rows(kernels: dict, summary: dict, mhz: float) -> dict:
    """The pipeline's warps (phase 8): each group loop's machine code, its
    longest chain of register dependences per tick, and the time that chain
    alone takes at the dependent-op latency P1 measured (the chain floor),
    for every instantiation the probe reports (``fir_pipe.REPORTED``).
    Returns the extra keys of the K1-K5, K2b, K3b and K4b rows, with their
    cycles per tick per thread (``roofline.summarize``)."""
    pipe = fir_pipe.pipe_sass(_build.sass("tpg"))
    floors = fir_pipe.chain_floor_ms(pipe, summary["tpg_cycles_per_dep_op"],
                                     mhz)
    for label, roles in pipe.items():
        print(f"  pipeline {label}: chain floor {floors[label]:.4f} ms; "
              "group loop (16 ticks) per warp:",
              json.dumps({role: {"insns": r["insns"],
                                 "chain_per_tick": r["chain_per_tick"]}
                          for role, r in roles.items()}))
    out = {}
    for k, label in (("K1", "K1 AbsRS"), ("K2", "K2 AbsRS"), ("K3", "K3"),
                     ("K3b", "K3b"), ("K4", "K4 AbsRS"),
                     ("K5", "K5 twopass 2"), ("K2b", "K2b AbsRS"),
                     ("K4b-slab", "K4b-slab AbsRS"),
                     ("K4b-gather", "K4b-gather AbsRS")):
        r = summary["kernels"][f"{k} ({kernels[k]['timed']})"]
        out[k] = {"cycles_per_tick": r["cycles_per_tick_per_thread"],
                  "chain_floor_ms": floors[label],
                  "group_loop_insns": {role: x["insns"]
                                       for role, x in pipe[label].items()},
                  "chain_per_tick": {role: x["chain_per_tick"]
                                     for role, x in pipe[label].items()}}
    return out


def probes_phase(dev, kernels: dict):
    """Phase 8.  Drives the four probe entries (their launches counted;
    each holds its kernels to their plain versions before it times
    anything), then holds the one-op and mix kernels and the carry layout
    to their plain versions at the rows' own shapes.  Every row's
    ``max_abs_err`` is the error measured where its comparison is made.
    Returns (rows, the int32 rate P1 sustained in 1e9 ops per second)."""
    probes.reset_launches()
    tpg.reset_launches()
    # ---- the entries, at full size; each checks parity before timing
    t0 = time.perf_counter()
    # every arm is held to the plain version at its own ilp, blocks and
    # threads before any arm is timed (roofline.check_arm)
    p1 = roofline.probe_arms(dev, roofline.ARMS, roofline.ITERS)
    sass_text = _build.sass("probes")
    p1_sass = roofline.loop_sass(sass_text)
    mhz = p1["sm_mhz"]
    per_step = {k: v["alu_per_step"] for k, v in p1_sass.items()}
    print(f"  P1 issue rate (SM clock {mhz} MHz; SASS per step of 3 source "
          f"ops: {json.dumps(per_step)}, loop of ilp 1: "
          f"{json.dumps(p1_sass[1]['loop'])})")
    for name, a in p1["arms"].items():
        print(f"    {name}: {a['blocks']} x {a['threads']} ilp {a['ilp']}: "
              f"{a['gops']:.1f} Gops/s, {a['ops_per_clk_per_sm']:.2f} "
              f"ops/clock/SM (nominal {INT32_LANES}), "
              f"{a['cycles_per_dep_op']:.3f} SM cycles per dependent op, "
              f"{a['ms']:.3f} ms at {roofline.ITERS[1]} iterations; "
              f"max abs err {a['max_abs_err']} against the plain version at "
              f"{a['check_iters']} iterations")
    kernel_ms = {}
    for k in KERNELS:
        fam = kernels[k]["timed"].split()[0]
        decode = "time2" if k == "K1" else "packed14" \
            if k.startswith("K4") else "plain"
        kernel_ms[f"{k} ({kernels[k]['timed']})"] = (fam, decode,
                                                     kernels[k]["ms"])
    summary = roofline.summarize(p1, kernel_ms, T_APA, C_APA)
    print(f"  TPG kernels against P1 (ceiling {summary['ceiling_gops']:.1f} "
          f"Gops/s; {summary['tpg_cycles_per_dep_op']:.3f} cycles per "
          "dependent op at 20 x 128, ilp 1):")
    for label, r in summary["kernels"].items():
        print(f"    {label}: {r['ms']:.4f} ms, {r['gops']:.1f} Gops/s = "
              f"{r['pct_of_ceiling']:.2f}% of the ceiling; "
              f"{r['cycles_per_tick_per_thread']:.1f} cycles per tick per "
              f"thread for {r['ops_per_tick']} ops = "
              f"{r['dep_ops_per_tick_at_probe_latency']:.1f} dependent ops "
              "at the probe's latency")
    pipe_rows = pipeline_rows(kernels, summary, mhz)
    print(f"  P1 in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    matrix = i16_ops.support_matrix(dev)
    bad = [k for k, v in matrix.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"P2: one-op kernels differ from their plain "
                             f"versions: {bad}")
    print("  P2 one-op record (instructions beyond the copy kernel's):",
          json.dumps(i16_ops.op_sass(sass_text)))
    mix = i16_ops.throughput_ab(dev, n_iters=i16_ops.N_ITERS,
                                geometries=i16_ops.GEOMETRIES)
    print("  P2 mix:", json.dumps(mix))
    print("  P2 mix SASS per step of one array:",
          json.dumps(i16_ops.mix_sass(sass_text)))
    print(f"  P2 in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    p3 = swar_frugal.run(dev, C_APA, T_APA)
    print("  P3 frugal chain:", json.dumps(p3))
    print("  P3 SASS per tick:",
          json.dumps(swar_frugal.frugal_sass(sass_text)))
    print(f"  P3 in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    ab = slots_ab.run(dev, C_APA, T_APA, datapaths="all")
    for label, r in ab.items():
        print(f"  slots A/B {label}: stacked {r['A_stacked']['ms']:.4f} ms, "
              f"null x{r['A2_null']['vs_A']:.4f}, carry "
              f"{r['B_word_carry']['ms']:.4f} ms (x"
              f"{r['B_word_carry']['vs_A']:.4f} of stacked); {r['hits']} "
              f"hits, {r['dropped']} dropped, carry == stacked")
    print(f"  slots A/B in {time.perf_counter() - t0:.1f} s", flush=True)
    counts = {**probes.launches,
              **{f"carry {k}": n
                 for k, n in tpg.process_window.carry_launches.items()}}
    print("  launches of the probe entries:", json.dumps(counts))

    # ---- each probe kernel against its plain version, for its row
    ceiling = summary["ceiling_gops"]

    def row(name, source, replaces, launches, err, ms, plain_ms, work,
            **extra):
        if launches <= 0:
            raise AssertionError(f"{name} was not launched by its entry")
        bound_ms, bound_by = bound(work, mhz, ceiling)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, **extra}

    def must_equal(what, got, want) -> int:
        err = probes.max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{what}: the kernel differs from its "
                                 f"plain version (max abs err {err})")
        return err

    # P1: the row is the TPG kernels' geometry; its error is the largest
    # over all arms' checks, so no instantiation or geometry goes unheld
    rows = []
    blocks, threads = roofline.TPG_GEOMETRY
    n = blocks * threads
    arm = p1["arms"]["tpg_ilp1"]
    rows.append(row(
        f"probe P1 issue rate (20 x 128, ilp 1, {roofline.ITERS[1]} "
        "iterations)", "fdreadoutlibs_tpu_torch/csrc/probes_issue.cu",
        "scripts/roofline.py:182", counts["P1"],
        max(a["max_abs_err"] for a in p1["arms"].values()), arm["ms"],
        arm["plain_ms"],
        {"bytes": 2 * 4 * n, "ops": roofline.OPS_PER_STEP * roofline.UNITS
         * n * roofline.ITERS[1]}, plain_n_iters=arm["check_iters"],
        arms_checked=len(p1["arms"]),
        cycles_per_dep_op=arm["cycles_per_dep_op"], ceiling_gops=ceiling))

    op_ms = op_plain_ms = 0.0
    op_err = 0
    for name in i16_ops.OP_NAMES:
        a, b = i16_ops.op_inputs(name, dev)
        got = i16_ops.one_op(name, a, b)
        want, ms = clock(lambda: i16_ops.op_plain(name, a, b))
        op_err = max(op_err, must_equal(f"P2 {name}", got, want))
        op_plain_ms += ms
        op_ms += probes.event_ms(lambda: i16_ops.one_op(name, a, b), 5)
    n_ops = len(i16_ops.OP_NAMES)
    rows.append(row(
        f"probe P2 one-op int16 kernels (mean of {n_ops}, (16, 128))",
        "fdreadoutlibs_tpu_torch/csrc/probes_i16.cu",
        "scripts/probe_i16_ops.py:47", counts["P2-ops"], op_err,
        op_ms / n_ops,
        op_plain_ms / n_ops, {"bytes": 3 * 2 * 16 * 128, "ops": 16 * 128}))

    b_tpg, per_block = i16_ops.GEOMETRIES["tpg"]
    feeds = i16_ops.mix_inputs(b_tpg * per_block, dev)
    plain_mix = {}
    mix_err = 0
    for arm_name in i16_ops.ARMS:
        got = i16_ops.mix(feeds[arm_name], i16_ops.N_ITERS, arm_name, b_tpg)
        want, plain_mix[arm_name] = clock(lambda: i16_ops.mix_plain(
            feeds[arm_name], i16_ops.N_ITERS, arm_name))
        mix_err = max(mix_err, must_equal(f"P2 mix {arm_name}", got, want))
    rows.append(row(
        f"probe P2 mix (int32 arm, {b_tpg * per_block} elements, "
        f"{i16_ops.N_ITERS} steps)",
        "fdreadoutlibs_tpu_torch/csrc/probes_i16.cu",
        "scripts/probe_i16_ops.py:146", counts["P2-mix"], mix_err,
        mix["tpg"]["ms_i32"], plain_mix["i32"],
        {"bytes": 2 * 4 * i16_ops.N_ARRAYS * b_tpg * per_block,
         "ops": MIX_OPS * i16_ops.N_ARRAYS * b_tpg * per_block
         * i16_ops.N_ITERS},
        ms_i16=mix["tpg"]["ms_i16"], ms_packed=mix["tpg"]["ms_packed"],
        plain_ms_i16=plain_mix["i16"], plain_ms_packed=plain_mix["packed"],
        i16_speedup=mix["tpg"]["i16_speedup"],
        packed_speedup=mix["tpg"]["packed_speedup"],
        saturating=mix["saturating"]))

    for arm_name, key in (("unpacked", "P3-unpacked"), ("packed",
                                                        "P3-packed")):
        width = C_APA if arm_name == "unpacked" else C_APA // 2
        rows.append(row(
            f"probe P3 frugal chain {arm_name} (T={T_APA} x {C_APA})",
            "fdreadoutlibs_tpu_torch/csrc/probes_swar.cu",
            "scripts/bench_swar_frugal.py:128", counts[key],
            max(p3[a]["max_abs_err"] for a in swar_frugal.ARMS
                if (a == "unpacked") == (arm_name == "unpacked")),
            p3[arm_name]["ms"], p3[arm_name]["plain_ms"],
            {"bytes": 4 * (T_APA * width + 4 * width),
             "ops": FRUGAL_OPS * T_APA * C_APA},
            swar_speedup=p3["swar_speedup"],
            **({"ms_packed_simd": p3["packed_simd"]["ms"],
                "ms_packed_minmax": p3["packed_minmax"]["ms"]}
               if arm_name == "packed" else {})))

    # ---- the carry layout on the reported case of each fused kernel,
    # against phase 3's plain result, timed in turns with the direct store
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for k in KERNELS:
        if k == "K5":                     # the two-pass schedule never
            continue                      # reads the flag
        run, want = kernels[k]["case"]
        with slots_ab.slot_word_carry():
            got = run()
            torch.cuda.synchronize()
            err = check_equal(f"SLOT_WORD_CARRY {k}", got, want)
            carry_ms = time_kernel(run, 10, flush)
        direct_ms = time_kernel(run, 10, flush)
        with slots_ab.slot_word_carry():
            carry_ms = (carry_ms + time_kernel(run, 10, flush)) / 2
        print(f"  SLOT_WORD_CARRY on {k} ({kernels[k]['timed']}, K={K}): "
              f"bit-equal to the plain version; carry {carry_ms:.4f} ms, "
              f"direct {direct_ms:.4f} ms in this call", flush=True)
        rows.append(row(
            f"tpg SLOT_WORD_CARRY on {k} ({kernels[k]['timed']})",
            "fdreadoutlibs_tpu_torch/csrc/tpg.cuh",
            "fdreadoutlibs_tpu/ops/pallas_tpg.py:67", counts[f"carry {k}"],
            err, carry_ms, kernels[k]["plain_ms"], kernels[k]["work"], varies=k,
            varies_ms_same_inputs=direct_ms))
    return rows, ceiling, pipe_rows


# ---- phase 9: the detector slice -------------------------------------------

DET_APA_LINKS = N_LINKS      # one APA: 2560 channels, fused feed (K4)
DET_PDS_LINKS = 10           # 40 channels (pds_readout.py's default)
DET_PDS_SC = 4               # superchunks per PDS link per batch: 3072 ticks
DET_TDE_LINKS = 12           # 12 AMCs x 64 channels (tde_file_creator)
DET_TIMED = 8                # steady batches per run (phase 4 has 16)
# detector time per batch of each arm: 128 WIBEth frames of 64 ticks x 32
# clocks; 4 x 12 DAPHNE-stream frames of 64 one-clock ticks; one TDE cycle
# of 5965 samples x 32 clocks; a 62.5 MHz clock is 16 ns
DET_SPAN_S = {"tpc": FRAMES * wibeth.EXPECTED_TICK_DIFFERENCE * 16e-9,
              "pds": DET_PDS_SC * pds_readout.TICKS_PER_SC * 16e-9,
              "tde": tde.EXPECTED_TICK_DIFFERENCE * 16e-9}
# run_model's windows per TDE cycle: 11 of 512 ticks and one of 333
TDE_WINDOWS = -(-tde.TOT_ADC16_SAMPLES // RUN_MODEL_WINDOW)
DET_SOURCES = {"tpc": detector_readout.TPC_SOURCE_BASE,
               "pds": detector_readout.PDS_SOURCE_BASE,
               "tde": detector_readout.TDE_SOURCE_BASE}


def detector_batches():
    """The phase's batches (warm-up + steady) for the three arms, and the
    ADCs of the checked ones: (T, 2560) TPC, (T, 40) PDS, (5965, 768) TDE
    int32, channels stacked link by link."""
    rng = np.random.default_rng(SEED + 9)
    batches, checked = [], []
    ts = {"tpc": 0x1000000, "pds": 0x2000000, "tde": 0x3000000}
    for b in range(N_WARM + DET_TIMED):
        frames, adcs = make_batch(rng, DET_APA_LINKS, FRAMES, b, ts["tpc"])
        scs, padcs = pds_readout.make_batch(rng, DET_PDS_LINKS, DET_PDS_SC,
                                            ts["pds"])
        tframes = detector_readout._tde_cycle(rng, DET_TDE_LINKS, ts["tde"],
                                              pulse=True)
        batches.append({"tpc": frames, "pds": scs, "tde": tframes,
                        "ts": dict(ts)})
        if b < N_CHECKED:
            T = padcs.shape[1]
            checked.append({
                "tpc": (adcs & 0x3FFF).transpose(1, 2, 0, 3)
                .reshape(FRAMES * 64, C_APA).astype(np.int32),
                "pds": padcs.transpose(1, 0, 2).reshape(
                    T, DET_PDS_LINKS * pds_readout.CH_PER_LINK)
                .astype(np.int32),
                "tde": tde.get_adc_samples(tframes).transpose(2, 0, 1)
                .reshape(tde.TOT_ADC16_SAMPLES, -1).astype(np.int32)})
        ts["tpc"] += FRAMES * wibeth.EXPECTED_TICK_DIFFERENCE
        ts["pds"] += DET_PDS_SC * pds_readout.TICKS_PER_SC
        ts["tde"] += tde.EXPECTED_TICK_DIFFERENCE
    return batches, checked


def plain_pds_hits(adcs_batches, app, dev):
    """What the PDS arm must fetch for consecutive (T, 40) batches: the
    kernel's plain version with the arm's seeding, tc, K and compaction,
    carrying state."""
    state = None
    for adcs in adcs_batches:
        T, C = adcs.shape
        if state is None:
            state = tpg.pack_state(seed_chanstate(
                init_chanstate(C), adcs[0], app.cfg.rs_memory_factor_x10), C,
                device=dev)
        tc = tpg.auto_tc(T, cap=kernel_knobs(app.cfg)["tc"])
        slots, nclose, state = tpg.process_window_plain(
            torch.from_numpy(adcs).to(dev), state, app.cfg, tc, app.k_slots,
            time_packed=False)
        yield unpack_compact(compact_on_device(slots, nclose, 0, C,
                                               max(2048, 2 * C)))


def plain_tde_hits(adcs_batches, cfg, dev):
    """What each TDE link's ``run_model(backend="pallas")`` must return for
    consecutive cycles: the kernel's plain version over every link's
    channels at once (channels are independent) in the same 512-tick
    windows, one chunk and 8 slots each, seeded from each channel's first
    sample, carrying state.  Yields per cycle a list of hits per link."""
    state = None
    for adcs in adcs_batches:
        T, C = adcs.shape
        if state is None:
            state = tpg.pack_state(seed_chanstate(
                init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10), C,
                device=dev)
        x = torch.from_numpy(adcs).to(dev)
        parts = []
        for t0 in range(0, T, RUN_MODEL_WINDOW):
            w = min(RUN_MODEL_WINDOW, T - t0)
            slots, nclose, state = tpg.process_window_plain(
                x[t0:t0 + w], state, cfg, w, RUN_MODEL_K, time_packed=False)
            parts.append(ingest.decode_slots(slots, nclose, C,
                                             tick_offset=t0)[0])
        hits = concat_hits(parts)
        out = []
        for l in range(C // tde.N_CHANNELS_PER_LINK):
            h = hits[hits["channel"] // tde.N_CHANNELS_PER_LINK == l].copy()
            h["channel"] -= l * tde.N_CHANNELS_PER_LINK
            out.append(h)
        yield out


def tpset_key(s):
    return (int(s.type), s.origin, s.start_time, s.end_time, s.seqno,
            s.objects.tobytes())


def time_ordered(sets) -> bool:
    """One drain of the merged stream is in (start_time, origin, seqno)
    order."""
    return sets == sorted(sets, key=lambda s: (s.start_time, s.origin,
                                               s.seqno))


def detector_run(pipelined: bool, batches, dev):
    """One run of the three-arm app over the batches: per-arm ms per call,
    the merged TPSet stream's drains (one after every batch, one after the
    flush), the fetched TPC and PDS
    hits and the TDE links' run_model hits of the checked batches, the
    launch counts, and the app."""
    app = detector_readout.DetectorReadoutApp(
        apa_links=DET_APA_LINKS, pds_links=DET_PDS_LINKS,
        tde_links=DET_TDE_LINKS, tde_backend="pallas", pipelined=pipelined,
        device=dev, fused_unpack=True)
    got = {"tpc": [], "pds": [], "tde": []}
    for arm, arm_app in (("tpc", app.tpc), ("pds", app.pds)):
        fetch = arm_app._fetch_hits

        def recording(packed, fetch=fetch, out=got[arm]):
            res = fetch(packed)
            out.append(res)
            return res
        arm_app._fetch_hits = recording
    real_run_model = tde_stream.run_model

    def recording_run_model(*a, **kw):
        res = real_run_model(*a, **kw)
        got["tde"].append(res[0])
        return res
    tde_stream.run_model = recording_run_model
    ms = {"tpc": [], "pds": [], "tde": []}
    drains = []
    tpg.reset_launches()
    try:
        for bat in batches:
            for arm, call in (("tpc", app.process_tpc_batch),
                              ("pds", app.process_pds_batch),
                              ("tde", app.process_tde_batch)):
                t0 = time.perf_counter()
                call(bat[arm])
                ms[arm].append((time.perf_counter() - t0) * 1e3)
            drains.append(app.drain_tpsets())
        t0 = time.perf_counter()
        app.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        drains.append(app.drain_tpsets())
    finally:
        tde_stream.run_model = real_run_model
    launches = dict(tpg.process_window.function_launches)
    tally()
    return {"app": app, "ms": ms, "flush_ms": flush_ms, "drains": drains,
            "sets": [s for d in drains for s in d], "got": got,
            "launches": launches}


def detector_slice(dev) -> dict:
    """Phase 9.  Returns the K2 and K4 launches of its two runs."""
    t0 = time.perf_counter()
    batches, checked = detector_batches()
    print(f"  data: {len(batches)} batches of {DET_APA_LINKS} WIBEth links x "
          f"{FRAMES} frames, {DET_PDS_LINKS} DAPHNE-stream links x "
          f"{DET_PDS_SC} superchunks, {DET_TDE_LINKS} TDE links x 64 "
          f"channels x one cycle in {time.perf_counter() - t0:.3f} s")
    n_b = len(batches)
    runs = {}
    for pipelined in (False, True):
        mode = "pipelined" if pipelined else "sync"
        r = runs[mode] = detector_run(pipelined, batches, dev)
        info = r["app"].get_info()
        want = {k: 0 for k in KERNELS}
        want["K4"] = n_b
        want["K2"] = n_b + n_b * DET_TDE_LINKS * TDE_WINDOWS
        summary = {}
        for arm in ("tpc", "pds", "tde"):
            steady = r["ms"][arm][N_WARM:]
            summary[arm] = {
                "ms_per_batch_p50": statistics.median(steady),
                "ms_per_batch_max": max(steady),
                "warm_up_ms": r["ms"][arm][0],
                "rtf": DET_SPAN_S[arm] * len(steady) / (sum(steady) / 1e3),
                "hits": info[arm]["total_hits"],
                "tps_sent": info[arm]["total_tps_sent"],
                "ts_errors": info[arm]["ts_errors"]}
        print(f"  {mode}: per arm (ms per batch over {DET_TIMED} steady "
              "batches, RTF = detector seconds over wall seconds):",
              json.dumps(summary), f"flush {r['flush_ms']:.3f} ms, TPSets "
              f"{len(r['sets'])}, launches "
              f"{json.dumps({k: v for k, v in r['launches'].items() if v})}",
              flush=True)
        if r["launches"] != want:
            raise AssertionError(f"detector {mode}: launches "
                                 f"{r['launches']}, want {want}")
        for arm, s in summary.items():
            if s["hits"] <= 0 or s["ts_errors"] != 0:
                raise AssertionError(f"detector {mode} {arm}: {s}")
        if not all(time_ordered(d) for d in r["drains"]):
            raise AssertionError(f"detector {mode}: a drain of the merged "
                                 "TPSet stream is not time-ordered")
        for arm, base in DET_SOURCES.items():
            own = [s for s in r["sets"] if s.origin == base]
            if not own or [s.seqno for s in own] != list(range(len(own))):
                raise AssertionError(f"detector {mode} {arm}: TPSets missing "
                                     "or out of sequence")
        r["summary"] = summary
    # the pipelined run emits each batch's TPSets a drain later: the
    # streams are equal TPSet for TPSet in each arm's sequence
    by_arm = {mode: sorted(map(tpset_key, r["sets"]),
                           key=lambda k: (k[1], k[4]))
              for mode, r in runs.items()}
    if by_arm["sync"] != by_arm["pipelined"]:
        raise AssertionError("detector: the sync and pipelined TPSet streams "
                             "differ")
    print(f"  sync and pipelined merged TPSet streams equal "
          f"({len(runs['sync']['sets'])} TPSets)")

    # each arm's hits against the plain version (sync run; the pipelined
    # run fetched the same batches in the same order)
    app = runs["sync"]["app"]
    rmf = np.concatenate([p.register_memory_factor for p in app.tpc.procs])
    plain = {
        "tpc": list(plain_app_hits([c["tpc"] for c in checked], rmf,
                                   app.tpc.cfg, app.tpc.k_slots, dev)),
        "pds": list(plain_pds_hits([c["pds"] for c in checked], app.pds,
                                   dev)),
        "tde": list(plain_tde_hits([c["tde"] for c in checked],
                                   app.tde.procs[0].tpg_cfg, dev))}
    for mode, r in runs.items():
        for b in range(N_CHECKED):
            for arm in ("tpc", "pds"):
                hits, d = r["got"][arm][b]
                want_h, want_d = plain[arm][b]
                if d != want_d or not np.array_equal(hits, want_h):
                    raise AssertionError(
                        f"detector {mode} {arm} batch {b}: hits ({len(hits)},"
                        f" dropped {d}) differ from the plain version "
                        f"({len(want_h)}, dropped {want_d})")
            tde_got = r["got"]["tde"][b * DET_TDE_LINKS:
                                      (b + 1) * DET_TDE_LINKS]
            for l, (h, want_h) in enumerate(zip(tde_got, plain["tde"][b])):
                if not np.array_equal(h, want_h):
                    raise AssertionError(
                        f"detector {mode} tde batch {b} link {l}: hits "
                        f"({len(h)}) differ from the plain version "
                        f"({len(want_h)})")
        print(f"  {mode}: batches 0-{N_CHECKED - 1} == plain: tpc "
              f"{[len(h) for h, _ in r['got']['tpc'][:N_CHECKED]]}, pds "
              f"{[len(h) for h, _ in r['got']['pds'][:N_CHECKED]]}, tde "
              f"{[sum(len(h) for h in x) for x in plain['tde']]} hits")

    # the request and fragment layer: raw frames from every arm, one
    # fragment per arm recorded and read back
    last = batches[-1]["ts"]
    spans = {"tpc": wibeth.EXPECTED_TICK_DIFFERENCE,
             "pds": pds_readout.TICKS_PER_SC, "tde": 1}
    rec_dir = tempfile.mkdtemp(prefix="chip_smoke_fragments_")
    try:
        rec = FragmentRecorder(rec_dir, run_number=app.run_number)
        for i, (arm, sid) in enumerate(DET_SOURCES.items()):
            window = (last[arm], last[arm] + spans[arm])
            raw = app.request_raw(sid, *window)
            frag = app.record_fragment(sid, *window, rec, trigger_number=i)
            back = rec.read(i)
            if len(raw) == 0 or back.header.source_id != sid or \
                    not np.array_equal(back.payloads, raw) or \
                    not np.array_equal(frag.payloads, raw):
                raise AssertionError(f"detector {arm}: request_raw / "
                                     "record_fragment wrong")
            print(f"  {arm}: request_raw {len(raw)} payloads; fragment "
                  f"source {back.header.source_id} "
                  f"{back.header.fragment_type} read back equal")
    finally:
        shutil.rmtree(rec_dir, ignore_errors=True)

    # the PDS arm's kernel alone on its batch (3072 ticks x 40 channels):
    # one channel's ticks are one serial chain, so its time bounds the
    # arm's real-time factor however few channels it has
    pds = app.pds
    words = daphne.stream_frames_bytes_to_u32(daphne.superchunk_frames(
        batches[-1]["pds"], stream=True).reshape(DET_PDS_LINKS, -1,
                                                 daphne.STREAM_FRAME_SIZE))
    feed = daphne.stream_unpack_frames(torch.from_numpy(words).to(dev)) \
        .reshape(DET_PDS_LINKS, -1, 4).transpose(0, 1) \
        .reshape(-1, DET_PDS_LINKS * 4).contiguous()
    T = feed.shape[0]
    tc = tpg.auto_tc(T, cap=kernel_knobs(pds.cfg)["tc"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    k_ms = time_kernel(lambda: tpg.process_window(
        feed, pds._stack, pds.cfg, tc, pds.k_slots, time_packed=False),
        20, flush)
    mhz = sm_clock_mhz()
    ns_tick = k_ms * 1e6 / T
    tde_feed = torch.from_numpy(checked[0]["tde"][:RUN_MODEL_WINDOW,
                                                  :tde.N_CHANNELS_PER_LINK]
                                .copy()).to(dev)
    tde_state = tpg.pack_state(seed_chanstate(
        init_chanstate(tde.N_CHANNELS_PER_LINK), checked[0]["tde"][0, :64],
        0), tde.N_CHANNELS_PER_LINK, device=dev)
    tde_cfg = app.tde.procs[0].tpg_cfg
    tde_ms = time_kernel(lambda: tpg.process_window(
        tde_feed, tde_state, tde_cfg, RUN_MODEL_WINDOW, RUN_MODEL_K,
        time_packed=False), 20, flush)
    print(f"  pds arm kernel K2 alone ({T} ticks x {DET_PDS_LINKS * 4} "
          f"channels, tc {tc}): {k_ms:.4f} ms per batch = {ns_tick:.2f} ns "
          f"per tick = {ns_tick * mhz / 1e3:.1f} cycles per tick at {mhz} "
          f"MHz; detector time per batch "
          f"{DET_SPAN_S['pds'] * 1e3:.6f} ms: kernel-only RTF "
          f"{DET_SPAN_S['pds'] * 1e3 / k_ms:.4f} (the serial-chain bound)")
    print(f"  tde arm kernel K2 alone (one 512-tick window x 64 channels, "
          f"8 slots): {tde_ms:.4f} ms per window, "
          f"{tde_ms * DET_TDE_LINKS * TDE_WINDOWS:.3f} ms for the "
          f"{DET_TDE_LINKS} links' {TDE_WINDOWS} windows of a cycle")
    print("  detector slice:", json.dumps({
        mode: {arm: {"ms_per_batch_p50": round(s["ms_per_batch_p50"], 4),
                     "rtf": round(s["rtf"], 4)}
               for arm, s in r["summary"].items()}
        for mode, r in runs.items()}))
    return {k: sum(r["launches"][k] for r in runs.values())
            for k in ("K2", "K4")}


# ---- phase 10: the modules slice -------------------------------------------

SCHED_APAS = 4               # README "Using it": 4 APAs of 40 links a card
SCHED_TIMED = 8              # steady batches per APA, after one warm-up
SCHED_K = 4                  # the APA app's k_slots
CLI_FRAMES = 32              # one link's frames in compare-backends' file
PROFILE_RUNS = (("AbsRS", [], "K2"), ("FIR", ["-t", "5"], "K3"),
                ("FIR", ["-t", "5", "--fir-twopass", "2"], "K5"))


def sched_stage_split(sched, frames, n_rep: int = 5):
    """One scheduler submit one step at a time (each synced): median ms per
    stage.  APA 0's carried state is left untouched."""
    L, N, _ = frames.shape
    T, C = N * wibeth.N_TIME_SAMPLES, L * wibeth.N_CHANNELS
    tc = tpg.auto_tc(T, cap=sched.tc)
    reps = []
    for _ in range(n_rep):
        r = {}
        words, r["words copy"] = clock(lambda: wibeth.frames_bytes_to_u32(
            frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(L, T, 28))
        dev_in, r["H2D"] = clock(lambda: torch.from_numpy(
            words.view(np.int32)).to(sched.device))
        feed, r["unpack"] = clock(lambda: wibeth.unpack_frames(
            dev_in.transpose(0, 1)).reshape(T, C))
        (slots, nclose, _), r["K2"] = clock(lambda: tpg.process_window(
            feed, sched._stacks[0], sched.cfg, tc, sched.k_slots,
            time_packed=False))
        packed, r["compaction"] = clock(lambda: compact_on_device(
            slots, nclose, 0, C, max(2048, 2 * C)))
        _, r["fetch"] = clock(lambda: unpack_compact(packed))
        reps.append(r)
    return {k: statistics.median(r[k] for r in reps) for k in reps[0]}


def same_hits(label: str, got, want) -> None:
    (hits, d), (want_h, want_d) = got, want
    if d != want_d or not np.array_equal(hits, want_h):
        raise AssertionError(f"{label}: hits ({len(hits)}, dropped {d}) "
                             f"differ from ({len(want_h)}, dropped {want_d})")


def batch_adcs(frames) -> np.ndarray:
    """(L, N, 7200) frames -> their (T, C) int32 ADCs."""
    L, N, _ = frames.shape
    return wibeth.get_adcs(frames.reshape(-1, wibeth.FRAME_SIZE)) \
        .reshape(L, N, 64, 64).transpose(1, 2, 0, 3) \
        .reshape(N * 64, L * 64).astype(np.int32)


def scheduler_run(dev, d: dict) -> dict:
    """The scheduler at full width on phase 4's data ``d``.  Returns its
    datapath launches."""
    n = len(d["batches"])
    # APA 0 takes phase 4's batches; APA k > 0 phase 4's batches from
    # another start, with the links rotated by 10 k
    frames = [[d["batches"][b] for b in range(1 + SCHED_TIMED)]] + [
        [np.roll(d["batches"][(b + 3 * k) % n], 10 * k, axis=0)
         for b in range(1 + SCHED_TIMED)] for k in range(1, SCHED_APAS)]
    sched = MultiAPAScheduler(d["cfg"], n_apas=SCHED_APAS, n_links=N_LINKS,
                              k_slots=SCHED_K, rs_memory_factor=d["rmf"],
                              device=dev)
    rng = np.random.default_rng(SEED + 10)
    got = {a: [] for a in range(SCHED_APAS)}

    def keep(outs):
        for apa, out in outs:
            if out is not None:
                got[apa].append(out)

    tpg.reset_launches()
    t0 = time.perf_counter()
    keep((int(a), sched.submit(int(a), frames[int(a)][0]))
         for a in rng.permutation(SCHED_APAS))
    keep(sorted(sched.flush().items()))
    warm_s = time.perf_counter() - t0
    submit_ms = []
    t0 = time.perf_counter()
    for b in range(1, 1 + SCHED_TIMED):
        for a in rng.permutation(SCHED_APAS):
            a = int(a)
            t1 = time.perf_counter()
            keep([(a, sched.submit(a, frames[a][b]))])
            submit_ms.append((time.perf_counter() - t1) * 1e3)
    keep(sorted(sched.flush().items()))
    wall = time.perf_counter() - t0
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    data_s = SCHED_APAS * SCHED_TIMED * FRAMES * 64 * 32 / 62.5e6
    info = sched.get_info()
    print(f"  scheduler: {SCHED_APAS} APAs x {N_LINKS} links "
          f"({SCHED_APAS} x {C_APA} channels), k_slots {SCHED_K}, tc "
          f"{tpg.auto_tc(T_APA, cap=sched.tc)}; warm-up round (one batch "
          f"an APA, then flushed) {warm_s:.4f} s; steady wall {wall:.4f} s "
          f"for {SCHED_APAS * SCHED_TIMED} submits, data {data_s:.6f} s, "
          f"aggregate_rtf {data_s / wall:.4f}, ms per submit p50 "
          f"{statistics.median(submit_ms):.4f} (max {max(submit_ms):.4f})",
          "launches", json.dumps({k: v for k, v in launches.items() if v}))
    want = {k: 0 for k in launches}
    want["K2"] = SCHED_APAS * (1 + SCHED_TIMED)
    if launches != want:
        raise AssertionError(f"scheduler: launches {launches}, want {want}")
    if info["batches"] != [1 + SCHED_TIMED] * SCHED_APAS or \
            any(len(got[a]) != 1 + SCHED_TIMED for a in got):
        raise AssertionError(f"scheduler: {info}, collected "
                             f"{[len(g) for g in got.values()]}")
    # APA 0 against phase 4's plain result: its end ticks are relative to
    # each batch, under the same cap of max(2048, 2C)
    for b, want_b in enumerate(d["plain"]):
        hits, dropped = got[0][b]
        hits = hits.copy()
        hits["end_tick"] -= b * T_APA
        same_hits(f"scheduler APA 0 batch {b} vs phase 4's plain result",
                  (hits, dropped), want_b)
    # APAs 1-3 against a single-APA StreamingIngest of their own batches
    for a in range(1, SCHED_APAS):
        ing = StreamingIngest(d["cfg"], N_LINKS, k_slots=SCHED_K,
                              device_compact=True,
                              max_hits=max(2048, 2 * C_APA),
                              rs_memory_factor=d["rmf"], device=dev)
        outs = [ing.submit(f) for f in frames[a]][1:] + [ing.flush()]
        for b, want_b in enumerate(outs):
            same_hits(f"scheduler APA {a} batch {b} vs StreamingIngest",
                      got[a][b], want_b)
    # and one batch of another APA against the plain version
    want_b = next(plain_app_hits([batch_adcs(frames[1][0])], d["rmf"],
                                 d["cfg"], SCHED_K, dev))
    same_hits("scheduler APA 1 batch 0 vs the plain version", got[1][0],
              want_b)
    print(f"  scheduler: APA 0 batches 0-{len(d['plain']) - 1} == phase 4's "
          f"plain result ({[len(h) for h, _ in got[0][:len(d['plain'])]]} "
          f"hits); APAs 1-{SCHED_APAS - 1} == single-APA StreamingIngest, "
          f"{1 + SCHED_TIMED} batches each "
          f"({[sum(len(h) for h, _ in got[a]) for a in got]} hits, dropped "
          f"{[sum(x for _, x in got[a]) for a in got]}); APA 1 batch 0 == "
          f"plain ({len(want_b[0])} hits)")
    split = sched_stage_split(sched, frames[0][-1])
    print("  scheduler stage split, one submit, ms (medians of 5, each stage "
          "synced):", json.dumps({k: round(v, 4) for k, v in split.items()}))
    return launches


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` in this process: (exit code, stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def trace_records(trace: str) -> dict:
    """A profile trace's device records beside the host calls that asked
    for them (kernels against launches, copies against copy calls) and
    the tpg kernel's records."""
    return {**device_records(trace),
            "pipe_kernel": sum(n for name, n in trace_counts(trace)[1].items()
                               if "pipe_kernel" in name)}


def cli_run(dev, td: str) -> dict:
    """The CLI on the card.  Returns its datapath launches."""
    def path(name):
        return os.path.join(td, name)

    def ok(argv, device=True):
        rc, out = run_cli(argv + (["--device", dev.type] if device else []))
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}: {out}")
        return out

    launches = {}

    def count():
        for k, v in tpg.process_window.kernel_launches.items():
            launches[k] = launches.get(k, 0) + v
        tally()

    tpg.reset_launches()
    ok(["make-zeros", "-o", path("z.bin"), "-n", "2"], device=False)
    ok(["pattern-generator", "-f", path("z.bin"), "-p", "golden",
        "--output", path("g.bin")], device=False)
    rep = json.loads(ok(["tpg-emulator", "-f", path("g.bin"), "-i",
                         "pallas", "--save-trigprim",
                         path("tps_pallas.txt")])[-1])
    # one link of pulses (one a channel on average) on noise: the default
    # SimpleThreshold at 499 fires on the pulses only, so no backend drops
    # a close (run_model's "pallas" holds 8 a window)
    make_batch(np.random.default_rng(SEED + 11), 1, CLI_FRAMES, 0,
               0x1000000, signal_rate=1.0)[0][0].tofile(path("link.bin"))
    out = ok(["compare-backends", "-f", path("link.bin"), "-b", "reference",
              "scan", "pallas"])
    if int(out[0].split()[1]) <= 0:
        raise AssertionError(f"cli compare-backends: no hits: {out}")
    count()
    ok(["tpg-emulator", "-f", path("g.bin"), "-i", "reference",
        "--save-trigprim", path("tps_ref.txt")])
    with open(path("tps_pallas.txt")) as f, open(path("tps_ref.txt")) as g:
        rows, ref_rows = f.read().splitlines()[1:], g.read().splitlines()[1:]
    if rep["hits"] != 2 or rows != ref_rows or \
            rows[0].split(",")[4:6] != ["4528", "506"]:
        raise AssertionError(f"cli golden round trip: {rep}, {rows} vs "
                             f"{ref_rows}")
    print(f"  cli: make-zeros -> pattern-generator -p golden -> tpg-emulator "
          f"-i pallas: {rep['hits']} hits (one golden hill a frame, charge "
          f"and peak of the first {rows[0].split(',')[4:6]}) == reference; "
          f"compare-backends on {CLI_FRAMES} frames of one link: "
          + "; ".join(out))
    with device_trace(path("trace_start")):
        pass        # the profiler's first start in a process (CUPTI) apart
    for alg, extra, kern in PROFILE_RUNS:
        tpg.reset_launches()
        trace = path(f"trace_{kern}")
        out = ok(["profile", "-a", alg, "--channels", str(C_APA), "--ticks",
                  str(T_APA), "--windows", "4", "-o", trace, "--top",
                  "20"] + extra)
        launched = dict(tpg.process_window.function_launches)
        # a capture CUPTI delivered short of device records is taken again
        retakes = [ln for ln in out[1:] if ln.startswith("# capture ")]
        if launched[kern] != 1 + 4 * (1 + len(retakes)):
            raise AssertionError(f"cli profile {alg} {extra}: launches "
                                 f"{launched}, retakes {retakes}")
        count()
        rep = json.loads(out[0])
        names = [ln for ln in out[1:] if "pipe_kernel" in ln]
        if not names:
            raise AssertionError(f"cli profile {alg} {extra}: the trace "
                                 "summary names no kernel: " + "\n".join(out))
        recorded = trace_records(trace)
        if recorded["kernel"] != recorded["launched"] or \
                recorded["gpu_memcpy"] != recorded["copied"] or \
                recorded["pipe_kernel"] != 4:
            raise AssertionError(f"cli profile {alg} {extra}: the trace "
                                 f"lacks device records: {recorded}")
        print(f"  cli profile -a {alg} {' '.join(extra)}: {kern} x 4 windows "
              f"of {T_APA} x {C_APA}, wall {rep['wall_s']} s, gsps_wall "
              f"{rep['gsps_wall']}, backend {rep['backend']}; device records "
              f"{recorded}, retakes {len(retakes)}; trace row: "
              f"{names[0].strip()[:160]}")
    return launches


def checkpoint_run(dev, td: str) -> dict:
    """Checkpoint/resume with the state on the card.  Returns the
    datapath launches."""
    frames, _ = patterns.pattern_frames(
        "golden", first_timestamp=10_000, crate_id=1, slot_id=2,
        stream_id=3, n_frames=4, channel=7, offset=60)

    def make():
        p = WIBEthFrameProcessor(tp_sink=QueueSender(), device=dev)
        p.conf({"crate_id": 1, "slot_id": 2, "link_id": 3,
                "enable_tpg": True, "tpg_threshold": 499,
                "tp_timeout": 100_000, "tpg_backend": "pallas"})
        p.start()
        return p

    tpg.reset_launches()
    cont = make()
    cont.process(frames.copy())
    want = np.concatenate(cont.tp_sink.drain())
    p1 = make()
    p1.process(frames[:2].copy())
    live = p1._dev_state is not None \
        and p1._dev_state.device.type == torch.device(dev).type \
        and p1._state_stale
    ckpt = checkpoint.checkpoint_processor(p1, os.path.join(td, "c.npz"))
    part1 = p1.tp_sink.drain()
    in_flight = int(p1.current_state()["hit_tover"][7])
    p2 = make()
    checkpoint.restore_processor(p2, ckpt)
    p2.process(frames[2:].copy())
    got = np.concatenate(part1 + p2.tp_sink.drain())
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    if not live or in_flight <= 0 or len(want) != 3 or \
            not np.array_equal(got, want):
        raise AssertionError(f"checkpoint on the card: state live {live}, "
                             f"hit in flight {in_flight}, TPs {len(got)} vs "
                             f"{len(want)} uninterrupted")
    print(f"  checkpoint: WIBEth pallas on the card, checkpointed after 2 "
          f"frames with the state on the card and a hit in flight (tover "
          f"{in_flight}), restored into a fresh processor: {len(got)} TPs "
          "== the uninterrupted run")
    return launches


def modules_slice(dev, apa_data: dict) -> dict:
    """Phase 10, on phase 4's data.  Returns the datapath launches of its
    counted runs."""
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    add(scheduler_run(dev, apa_data))
    tpg.reset_launches()
    fn, args = entry(device=dev)
    hits, n_hits, state = fn(*args)
    torch.cuda.synchronize()
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    add(launches)
    fn_c, args_c = entry(device="cpu")
    hits_c, n_c, state_c = fn_c(*args_c)
    if launches["K4"] != 1 or int(n_hits) != int(n_c) or \
            not torch.equal(hits.cpu(), hits_c) or \
            not torch.equal(state.cpu(), state_c):
        raise AssertionError(f"entry() on the card differs from the CPU "
                             f"(n_hits {int(n_hits)} vs {int(n_c)}, "
                             f"launches {launches})")
    print(f"  entry(): K4 once (tc {entry_mod.TC}, k_slots "
          f"{entry_mod.K_SLOTS}), {int(n_hits)} hit "
          f"{hits[0].tolist()}, hits and new state == entry(device='cpu')")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_modules_") as td:
        add(cli_run(dev, td))
        add(checkpoint_run(dev, td))
    return total


# ---- phase 11: the parallel slice ------------------------------------------

PAR_K = 8                    # make_apa_step's k_slots
PAR_TIMED = 8                # steady batches per run, after one warm-up
PAR_CAP = 512                # APAPipeline's max_hits_per_link
PAR_SHARDS = (1, 8)          # the whole APA on one shard; 5 links a shard
PAR_INGESTS = {"canonical": ({}, "K2"),
               "fused": ({"fused_unpack": True}, "K4"),
               "time2": ({"time2_feed": True}, "K1")}
PAR_BAD_LINK = N_LINKS // 2  # the link that takes garbage words
PAR_APAS, PAR_APA_SHARDS = 4, 2
SOAK_WINDOWS, SOAK_TICKS = 40, 4096
BATCH_S = T_APA * 32 / 62.5e6     # 4.194 ms of detector time a batch


def frames_words(frames) -> np.ndarray:
    """(L, N, 7200) frames -> their (L, T, 28) uint32 ADC words."""
    L, N, _ = frames.shape
    return wibeth.frames_bytes_to_u32(frames.reshape(-1, wibeth.FRAME_SIZE)) \
        .reshape(L, N * wibeth.N_TIME_SAMPLES, 28)


def first_adcs(words) -> np.ndarray:
    """The first tick of each link's words, (..., L, 64) int32."""
    return unpack_14bit(np.asarray(words[..., 0, :]), 64).astype(np.int32)


def plain_pipeline_hits(words_batches, rmf, cfg, dev):
    """What the pipeline must return for consecutive batches: the kernel's
    plain version over the whole APA with the pipeline's seeding, tc
    (``auto_tc(T)``), K and per-link compaction under the per-link cap,
    carrying state.  Yields (hits, n_hits, total, dropped) as numpy."""
    body = par_apa._ShardBody(cfg, PAR_CAP, "pallas", PAR_K, False, False, 0)
    state = None
    for words in words_batches:
        L, T, _ = words.shape
        C = L * wibeth.N_CHANNELS
        adcs = wibeth.unpack_frames(torch.from_numpy(words.view(np.int32))
                                    .to(dev).transpose(0, 1)).reshape(T, C)
        if state is None:
            state = tpg.pack_state(seed_chanstate(
                init_chanstate(C), first_adcs(words).reshape(-1), rmf), C,
                device=dev)
        slots, nclose, state = tpg.process_window_plain(
            adcs, state, cfg, tpg.auto_tc(T), PAR_K, time_packed=False)
        hits, n_hits, total, dropped = body.compact((slots, nclose), L)
        yield (hits.cpu().numpy(), n_hits.cpu().numpy(), int(total),
               int(dropped))


def new_pipeline(dev, cfg, rmf, words0, n_shards: int, flags=None):
    pipe = APAPipeline(N_LINKS, cfg,
                       mesh=make_link_mesh(n_shards, device=dev),
                       backend="pallas", **(flags or {}))
    pipe.init_state(first_adcs(words0), rs_memory_factor=rmf)
    return pipe


def step_out(pipe, words) -> tuple:
    """One batch through the pipeline and fetched: (hits, n_hits, total,
    dropped in this batch) as numpy."""
    before = pipe.dropped_hits
    hits, n_hits, total = pipe.process(words)
    return np.asarray(hits), np.asarray(n_hits), total, \
        pipe.dropped_hits - before


def same_step(label: str, got, want) -> None:
    for g, w, what in zip(got, want, ("hits", "n_hits", "total",
                                      "dropped")):
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: {what} differ")


def same_state(label: str, got: dict, want: dict, links=slice(None)):
    for k in want:
        if not np.array_equal(np.asarray(got[k])[links],
                              np.asarray(want[k])[links]):
            raise AssertionError(f"{label}: state {k} differs")


def pipeline_stage_split(pipe, frames, n_rep: int = 5):
    """One batch through the pipeline one stage at a time, each ended by a
    device sync: median ms per stage (with more than one shard also the
    shards' kernels launched one after another on one stream).  The
    pipeline's carried state is left untouched."""
    step = pipe.step
    reps = []
    for _ in range(n_rep):
        r = {}
        words, r["host words"] = clock(lambda: frames_words(frames))
        host, r["host relayout"] = clock(lambda: pipe.host_feed(words))
        feeds, r["H2D"] = clock(lambda: step.upload(host))
        kern, r["kernels"] = clock(lambda: step.on_streams(
            step.body.kernel, feeds, pipe._stacks))
        if len(step.cells) > 1:
            _, r["kernels, one stream"] = clock(lambda: [
                step.body.kernel(f, s) for f, s in zip(feeds, pipe._stacks)])
        n_links = [s.shape[1] // wibeth.N_CHANNELS for s in pipe._stacks]

        def compact():
            comp = step.on_streams(step.body.compact, [o for o, _ in kern],
                                   n_links)
            step.join()
            return step.gather(comp)

        out, r["compaction"] = clock(compact)
        _, r["fetch"] = clock(lambda: (np.asarray(out[0]),
                                       np.asarray(out[1]),
                                       torch.stack(out[2:]).tolist()))
        reps.append(r)
    return {k: statistics.median(r[k] for r in reps) for k in reps[0]}


def pipeline_run(dev, words, cfg, rmf, ingest: str, n_shards: int) -> dict:
    """One ingest on one mesh: 1 warm-up batch and PAR_TIMED steady ones,
    each fetched.  Returns its outputs, final state, times and launches."""
    flags, kern = PAR_INGESTS[ingest]
    pipe = new_pipeline(dev, cfg, rmf, words[0], n_shards, flags)
    tpg.reset_launches()
    outs, ms = [], []
    t_steady = None
    for b, w in enumerate(words):
        if b == N_WARM:
            t_steady = time.perf_counter()
        t1 = time.perf_counter()
        outs.append(step_out(pipe, w))
        ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t_steady
    launched = dict(tpg.process_window.function_launches)
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    want = {k: 0 for k in KERNELS}
    want[kern] = n_shards * len(words)
    if launched != want:
        raise AssertionError(f"pipeline {ingest} x {n_shards}: launches "
                             f"{launched}, want {want}")
    return {"pipe": pipe, "outs": outs, "ms": ms, "wall": wall,
            "state": {k: np.asarray(v) for k, v in pipe.state.items()},
            "launches": launches}


def resume_run(dev, words, cfg, rmf, want_b2) -> dict:
    """The sharded checkpoint at full width: the 8-shard state after batch
    1, restored into fresh 8- and 1-shard pipelines, replays batch 2 as the
    uninterrupted run; then garbage words on one link in batch 2 leave
    every other link's hits and state as they were.  Returns the
    datapath launches."""
    tpg.reset_launches()
    cont = new_pipeline(dev, cfg, rmf, words[0], 8)
    for w in words[:2]:
        cont.process(w)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as td:
        checkpoint.save_sharded_state(td + "/apa", cont.state)
        got = step_out(cont, words[2])
        same_step("uninterrupted batch 2 vs the timed run", got, want_b2)
        want_state = {k: np.asarray(v) for k, v in cont.state.items()}
        for n in (8, 1):
            p = new_pipeline(dev, cfg, rmf, words[0], n)
            p.state = checkpoint.load_sharded_state(td + "/apa", p.state)
            same_step(f"resumed on {n} shards, batch 2",
                      step_out(p, words[2]), want_b2)
            same_state(f"resumed on {n} shards", p.state, want_state)
    bad = words[2].copy()
    bad[PAR_BAD_LINK] = np.random.default_rng(SEED + 12).integers(
        0, 2 ** 32, size=bad.shape[1:], dtype=np.uint32)
    p = new_pipeline(dev, cfg, rmf, words[0], 8)
    for w in words[:2]:
        p.process(w)
    hits, n_hits, _, _ = step_out(p, bad)
    ok = [link for link in range(N_LINKS) if link != PAR_BAD_LINK]
    if not (np.array_equal(hits[ok], want_b2[0][ok])
            and np.array_equal(n_hits[ok], want_b2[1][ok])):
        raise AssertionError("fault isolation: another link's hits moved")
    same_state("fault isolation", p.state, want_state, ok)
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    print(f"  sharded resume: the 8-shard state after batch 1, restored "
          f"into fresh 8- and 1-shard pipelines, replays batch 2 == the "
          f"uninterrupted run ({int(want_b2[2])} hits, state bit-exact); "
          f"garbage words on link {PAR_BAD_LINK} in batch 2: link "
          f"{PAR_BAD_LINK} {int(n_hits[PAR_BAD_LINK])} hits (was "
          f"{int(want_b2[1][PAR_BAD_LINK])}), every other link's hits and "
          "state untouched", "launches",
          json.dumps({k: v for k, v in launches.items() if v}))
    return launches


def detector_pipeline_run(dev, d: dict) -> dict:
    """4 APAs x 40 links on a (4, 2) ('apa', 'link') mesh on the card,
    canonical ingest: APA 0 takes phase 4's batches, APA a phase 4's
    batches from another start with the links rotated by 10 a (as phase
    10).  Each APA equals a 1-shard ``APAPipeline`` of its own batches.
    Returns the datapath launches."""
    n = len(d["batches"])
    nb = N_WARM + PAR_TIMED
    words = [np.stack([frames_words(np.roll(d["batches"][(b + 3 * a) % n],
                                            10 * a, axis=0))
                       for a in range(PAR_APAS)]) for b in range(nb)]
    det = DetectorPipeline(
        PAR_APAS, N_LINKS, d["cfg"], backend="pallas",
        mesh=make_apa_link_mesh(PAR_APAS, PAR_APA_SHARDS, device=dev))
    det.init_state(first_adcs(words[0]), rs_memory_factor=d["rmf"])
    tpg.reset_launches()
    outs, ms = [], []
    for b, w in enumerate(words):
        if b == N_WARM:
            t_steady = time.perf_counter()
        t1 = time.perf_counter()
        before = det.dropped_hits.copy()
        hits, n_hits, totals = det.process(w)
        outs.append((np.asarray(hits), np.asarray(n_hits), totals,
                     det.dropped_hits - before))
        ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t_steady
    launched = dict(tpg.process_window.function_launches)
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    want = {k: 0 for k in KERNELS}
    want["K2"] = PAR_APAS * PAR_APA_SHARDS * nb
    if launched != want:
        raise AssertionError(f"detector pipeline: launches {launched}, "
                             f"want {want}")
    data_s = PAR_APAS * PAR_TIMED * BATCH_S
    state = det.state
    for a in range(PAR_APAS):
        ref = new_pipeline(dev, d["cfg"], d["rmf"], words[0][a], 1)
        for b, w in enumerate(words):
            got = outs[b]
            if not np.array_equal(got[2][a], got[1][a].sum()):
                raise AssertionError(f"detector APA {a} batch {b}: total "
                                     f"{got[2][a]} != sum of n_hits")
            same_step(f"detector APA {a} batch {b} vs APAPipeline",
                      (got[0][a], got[1][a], got[2][a], got[3][a]),
                      step_out(ref, w[a]))
        same_state(f"detector APA {a}",
                   {k: np.asarray(v)[a] for k, v in state.items()},
                   ref.state)
    per_apa = [int(sum(o[2][a] for o in outs)) for a in range(PAR_APAS)]
    print(f"  detector pipeline: {PAR_APAS} APAs x {N_LINKS} links on a "
          f"({PAR_APAS}, {PAR_APA_SHARDS}) mesh on {dev}, canonical (K2), "
          f"warm-up {ms[0]:.3f} ms; ms per batch p50 "
          f"{statistics.median(ms[N_WARM:]):.4f} (max "
          f"{max(ms[N_WARM:]):.4f}), aggregate_rtf {data_s / wall:.4f}; "
          f"per-APA hits {per_apa}, dropped "
          f"{[int(x) for x in det.dropped_hits]}; each APA == an "
          "APAPipeline of its own batches, totals == sums of n_hits",
          "launches", json.dumps({k: v for k, v in launches.items() if v}))
    return launches


def parallel_slice(dev, apa_data: dict) -> dict:
    """Phase 11, on phase 4's data.  Returns the datapath launches of its
    counted runs."""
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    cfg, rmf = apa_data["cfg"], apa_data["rmf"]
    words = [frames_words(f) for f in
             apa_data["batches"][:N_WARM + PAR_TIMED]]
    t0 = time.perf_counter()
    plain = list(plain_pipeline_hits(words[:N_CHECKED], rmf, cfg, dev))
    print(f"  plain version of batches 0-{N_CHECKED - 1} (tc "
          f"{tpg.auto_tc(T_APA)}, K {PAR_K}, cap {PAR_CAP} a link) in "
          f"{time.perf_counter() - t0:.3f} s: hits "
          f"{[p[2] for p in plain]}, dropped {[p[3] for p in plain]}")
    runs, summary = {}, {}
    for ingest, (_, kern) in PAR_INGESTS.items():
        for n in PAR_SHARDS:
            r = runs[(ingest, n)] = pipeline_run(dev, words, cfg, rmf,
                                                 ingest, n)
            add(r["launches"])
            for b, want in enumerate(plain):
                same_step(f"pipeline {ingest} x {n} batch {b} vs the plain "
                          "version", r["outs"][b], want)
            first = runs[("canonical", 1)]
            for b, (got, want) in enumerate(zip(r["outs"], first["outs"])):
                same_step(f"pipeline {ingest} x {n} batch {b} vs canonical "
                          "x 1", got, want)
            same_state(f"pipeline {ingest} x {n}", r["state"],
                       first["state"])
            split = pipeline_stage_split(r["pipe"],
                                         apa_data["batches"][N_WARM])
            p50 = statistics.median(r["ms"][N_WARM:])
            rtf = PAR_TIMED * BATCH_S / r["wall"]
            summary[f"{ingest} x {n}"] = {
                "ms_per_batch_p50": round(p50, 4), "rtf": round(rtf, 4),
                "split_ms": {k: round(v, 4) for k, v in split.items()}}
            print(f"  APAPipeline {ingest} ({kern}), {n} shard(s) of "
                  f"{N_LINKS // n} links on {dev}: warm-up "
                  f"{r['ms'][0]:.3f} ms; ms per batch p50 {p50:.4f} (max "
                  f"{max(r['ms'][N_WARM:]):.4f}), rtf {rtf:.4f}; hits "
                  f"{sum(o[2] for o in r['outs'])}, dropped "
                  f"{r['pipe'].dropped_hits}; batches 0-{N_CHECKED - 1} == "
                  "plain, every batch and the state == canonical x 1; "
                  "stage split (ms, medians of 5, each stage synced):",
                  json.dumps(summary[f"{ingest} x {n}"]["split_ms"]),
                  flush=True)
    print("  APAPipeline, 1 shard vs 8 shards of one APA on one card:",
          json.dumps(summary))
    add(resume_run(dev, words, cfg, rmf, runs[("canonical", 8)]["outs"][2]))
    del runs
    add(detector_pipeline_run(dev, apa_data))
    tpg.reset_launches()
    dryrun_multichip(8)
    launches = dict(tpg.process_window.kernel_launches)
    tally()
    add(launches)
    print("  dryrun_multichip(8) launches",
          json.dumps({k: v for k, v in launches.items() if v}))
    for ingest in soak.INGESTS:
        tpg.reset_launches()
        rec = soak.run(SOAK_WINDOWS, SOAK_TICKS, C_APA, "AbsRS", ingest, dev)
        print(" ", json.dumps(rec))
        soak.check(rec)
        launched = dict(tpg.process_window.function_launches)
        kern = {"plain": "K2", "time2": "K1"}.get(ingest, "K4")
        if launched[kern] != 2 * SOAK_WINDOWS or \
                sum(launched.values()) != 2 * SOAK_WINDOWS:
            raise AssertionError(f"soak {ingest}: launches {launched}")
        add(dict(tpg.process_window.kernel_launches))
        tally()
        print(f"  SOAK OK ({ingest}, {kern} x {2 * SOAK_WINDOWS})")
    return total


# ---- phase 12: the tool slice ----------------------------------------------

TUNE_GEOMETRY = autotune.QUICK_GEOMETRY    # the one non-shipped geometry
TUNE_C, TUNE_T = C_APA, T_APA              # the JAX tuner's 2560 x 8192
TUNE_WINDOWS, TUNE_TRIALS, TUNE_CONFIRM, TUNE_CONFIRM_TRIALS = 4, 2, 2, 2
FUZZ_SWEEP_SEEDS, FUZZ_SWEEP_START, FUZZ_KERNEL_EVERY = 20, 20_000, 2
FUZZ_FRAMES_PER_RIG, FUZZ_FRAMES_START = 3, 50_000
FUZZ_TP_CASES, FUZZ_TP_START = 20, 56_000


def tuned_apa_batch(dev, d: dict, tuned: dict) -> dict:
    """The tuned file written by the tuner, read back through
    ``kernel_knobs``, drives one APA batch of phase 4's data on the time2
    feed (K1); its hits equal the plain app's at those knobs.  The file is
    the phase's own: ``FDREADOUT_TUNED`` is restored after.  Returns the
    batch's datapath launches."""
    old = os.environ.get("FDREADOUT_TUNED")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "tuned.json")
        with open(path, "w") as f:
            json.dump(tuned, f)
        os.environ["FDREADOUT_TUNED"] = path
        try:
            knobs = kernel_knobs(d["cfg"])
            entry = tuned["AbsRS"]
            got = (knobs["tc"], knobs["k_slots"], tuple(knobs["geometry"]))
            want = (entry["tc"], entry["k"],
                    tuple(entry[f] for f in ("group", "stage_ticks",
                                             "stages")))
            if got != want:
                raise AssertionError(f"kernel_knobs read {got} from the "
                                     f"tuned file, not {want}")
            app = APAReadoutApp(n_links=N_LINKS, algorithm="AbsRS",
                                threshold=150, threshold_on_collection=True,
                                device=dev, time2_feed=True)
            fetched = []
            fetch = app._fetch_hits
            app._fetch_hits = lambda packed: fetched.append(
                fetch(packed)) or fetched[-1]
            tpg.reset_launches()
            app.process_batch(d["batches"][0])
            app.flush()
            launched = dict(tpg.process_window.kernel_launches)
            tally()
            plain = next(plain_app_hits([batch_adcs(d["batches"][0])],
                                        d["rmf"], d["cfg"], app.k_slots,
                                        dev))
            same_hits("APA batch 0 under the tuned file vs the plain app",
                      fetched[0], plain)
            print(f"  tuned file -> kernel_knobs {json.dumps(got)}: APA "
                  f"batch 0 (time2, K1 x {launched['K1']}) "
                  f"{len(plain[0])} hits, {plain[1]} dropped == plain")
        finally:
            if old is None:
                os.environ.pop("FDREADOUT_TUNED", None)
            else:
                os.environ["FDREADOUT_TUNED"] = old
    return launched


def tool_slice(dev, apa_data: dict) -> dict:
    """Phase 12.  Returns the datapath launches of its main paths: the
    fuzzers, the tuner and the tuned APA batch."""
    add = collections.Counter()
    # the geometry's library builds while the fuzzers run on the shipped one
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build, "tpg",
                            tpg.geometry_defines(TUNE_GEOMETRY))
        fuzzers(dev, add)
        lib = build.result()
    print(f"  built {lib.name} (geometry {tuple(TUNE_GEOMETRY)}) in "
          f"{time.perf_counter() - t0:.1f} s, beside the fuzzers")

    t0 = time.perf_counter()
    tpg.reset_launches()
    tuned = autotune.run(dev, quick=True, geometries=[TUNE_GEOMETRY],
                         C=TUNE_C, T=TUNE_T, windows=TUNE_WINDOWS,
                         trials=TUNE_TRIALS, confirm=TUNE_CONFIRM,
                         confirm_trials=TUNE_CONFIRM_TRIALS, check=True,
                         log=lambda line: None)
    add.update(tpg.process_window.kernel_launches)
    tally()
    print(f"  autotune --quick --confirm {TUNE_CONFIRM} ({TUNE_C} x "
          f"{TUNE_T}, {TUNE_WINDOWS} windows, {TUNE_TRIALS} trials; every "
          "candidate == the plain version at its tc and k, the geometry == "
          f"the shipped one) in {time.perf_counter() - t0:.1f} s")
    print("  ptxas per geometry (group, stage_ticks, stages; the shipped "
          "one first):", json.dumps(tuned["ptxas"]))
    for alg, rows in tuned["sweep"].items():
        print(f"  autotune {alg} ms per window:", json.dumps(
            [{k: r[k] for k in ("tc", "k", "twopass", "group",
                                "stage_ticks", "stages", "ms") if k in r}
             for r in sorted(rows, key=lambda r: r["ms"])]))
    for alg, entry in tuned["tuned"].items():
        print(f"  autotune {alg} entry:", json.dumps(
            {k: v for k, v in entry.items() if k != "confirm"}),
            "confirm ms per pass:", json.dumps(
                [[r[k] for k in ("tc", "k", "twopass", "group",
                                 "stage_ticks", "stages") if k in r]
                 + [r["ms_passes"]] for r in entry.get("confirm", [])]))
    if set(tuned["tuned"]) != set(autotune.ALGS):
        raise AssertionError(f"tuned {sorted(tuned['tuned'])}")
    add.update(tuned_apa_batch(dev, apa_data, tuned["tuned"]))
    return dict(add)


def fuzzers(dev, add) -> None:
    """The three fuzzers of phase 12, their datapath launches into
    ``add``; raises on any mismatch."""
    launched = {}
    tpg.reset_launches()
    sweep = fuzz_sweep.sweep(FUZZ_SWEEP_SEEDS, FUZZ_SWEEP_START, dev,
                             FUZZ_KERNEL_EVERY)
    add.update(tpg.process_window.kernel_launches)
    launched["fuzz_sweep"] = dict(tpg.process_window.function_launches)
    tally()
    print("  fuzz_sweep:", json.dumps(sweep))
    tpg.reset_launches()
    frames = fuzz_frames.sweep(0, FUZZ_FRAMES_START, dev,
                               per_rig=FUZZ_FRAMES_PER_RIG)
    add.update(tpg.process_window.kernel_launches)
    launched["fuzz_frames"] = dict(tpg.process_window.function_launches)
    tally()
    print("  fuzz_frames:", json.dumps(frames))
    print("  fuzzers' launches per kernel function:", json.dumps(
        {k: {f: n for f, n in v.items() if n} for k, v in launched.items()}))
    tp_path = fuzz_tp_path.sweep(FUZZ_TP_CASES, FUZZ_TP_START, hammer=1)
    print("  fuzz_tp_path (host):", json.dumps(tp_path))
    for name, res, n in (("fuzz_sweep", sweep, "failures"),
                         ("fuzz_frames", frames, "failures"),
                         ("fuzz_tp_path", tp_path, "failures"),
                         ("fuzz_tp_path hammer", tp_path,
                          "hammer_failures")):
        if res[n]:
            raise AssertionError(f"{name}: {res[n]} mismatches")
    if not all(sum(v.values()) for v in launched.values()):
        raise AssertionError(f"a fuzzer launched no kernel: {launched}")


# ---- phase 13: the bench ----------------------------------------------------

# the bench's own parameters, cut: trials, windows a chain, the app's timed
# and warm-up batches, the latency arm's timed batches, seconds a codec
BENCH_COUNTS = {"trials": 1, "n_windows": 2, "timed": 2, "warm": 1,
                "batches": 2, "seconds": 0.25}


def bench_phase(dev) -> dict:
    """Phase 13.  Returns the datapath launches of the bench's run."""
    tpg.reset_launches()
    line = bench.run(dev, **BENCH_COUNTS)
    launched = dict(tpg.process_window.kernel_launches)
    tally()
    text = json.dumps(line)
    line = json.loads(text)
    print("  bench line:", text)
    missing = [k for k in bench.KEYS if k not in line]
    if missing or bench.failures(line) or line["parity"] is not True:
        raise AssertionError(f"bench: missing {missing}, failed "
                             f"{bench.failures(line)}, parity "
                             f"{line['parity']}")
    app = line["app_rtf"]
    rtfs = {"value": line["value"], **line["algorithms"],
            **line["production_variants"],
            "app_rtf": app["rtf_pipelined"],
            "app_rtf unpipelined": app["rtf_unpipelined"],
            **{f"app_rtf {f} {m}": v[m] for f, v in app["feeds"].items()
               for m in ("rtf_pipelined", "rtf_unpipelined")},
            **{f"frontends {a}": v["rtf"]
               for a, v in line["frontends"].items()}}
    if min(rtfs.values()) <= 0:
        raise AssertionError(f"bench: an RTF is not above 0: {rtfs}")
    print(f"  bench: parity over {len(line['parity_cells'])} cells, "
          f"headline {line['value']}, app_rtf pipelined "
          f"{app['rtf_pipelined']}, {line['wall_s']} s; launches per "
          "datapath:", json.dumps({k: v for k, v in launched.items() if v}))
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with phase("1 device"):
        # refuses a card that is not capability (9, 0): built for sm_90a
        info = device_preflight(dev)
        name = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        print(f"device: {name}, count {torch.cuda.device_count()}, "
              f"versions {json.dumps(info)}")
        print(smi)

    with phase("2 build"):
        for lib_name in ("probes", "tpg"):
            t0 = time.perf_counter()
            lib = _build.build(lib_name)
            print(f"built {lib.name} ({len(_build.units(lib_name))} units) "
                  f"in {time.perf_counter() - t0:.1f} s")
            if lib_name in _build.build_log:
                print(f"  ptxas {lib_name}:",
                      ptxas_summary(_build.build_log[lib_name]))
            _build.load(lib_name)
        if "tpg" in _build.build_log:
            regs = ptxas_kernels(_build.build_log["tpg"])
            print("  ptxas FIR kernels, the pipeline (K3 and K3b on plain, "
                  "time2, packed, gather14 and slab14 rows, K2b's FIR, K5, "
                  "the staged arm; registers min, max, spill stores B):",
                  json.dumps(fir_registers(regs)))
            thr_regs = threshold_registers(regs)
            print("  ptxas threshold pipeline, every instantiation (K1, K2, "
                  "K4, K4b-gather, K4b-slab, K2b, their carry layout and "
                  "staged arms; registers, spill stores B):",
                  json.dumps(thr_regs))
            k4b = {n: v for n, v in regs.items()
                   if re.search(r"pipe_kernelILi[34]E", n)
                   and "FirPackedChannel" not in n}
            print(f"  ptxas K4b (pipe_kernel on gather14 and slab14 rows): "
                  f"{len(k4b)} instantiations, registers "
                  f"{min(r for r, _ in k4b.values())}-"
                  f"{max(r for r, _ in k4b.values())}, spill stores max "
                  f"{max(sp for _, sp in k4b.values())} B")
            if any(sp for _, sp in k4b.values()):
                raise AssertionError("K4b instantiations spill: " + json.dumps(
                    {pipe_name(n): v for n, v in k4b.items() if v[1]}))
            k3b = {n: v for n, v in regs.items() if "FirPackedChannel" in n}
            if not k3b or any(pipe_name(n) is None for n in k3b):
                raise AssertionError("K3b is not (only) pipe_kernel: "
                                     + json.dumps(sorted(k3b)))
            k3b = {pipe_name(n): v for n, v in k3b.items()}
            print(f"  ptxas K3b (pipe_kernel, K3's mode with the packed "
                  f"front and back): {len(k3b)} instantiations (registers, "
                  "spill stores B):", json.dumps(dict(sorted(k3b.items()))))
            if any(sp for _, sp in k3b.values()):
                raise AssertionError("K3b instantiations spill: " + json.dumps(
                    {n: v for n, v in k3b.items() if v[1]}))
            pipe_spills = {pipe_name(n): v[1] for n, v in regs.items()
                           if pipe_name(n) is not None}
            print(f"  ptxas pipeline: {len(pipe_spills)} instantiations, "
                  f"{sum(1 for v in pipe_spills.values() if v)} with spill "
                  "stores:", json.dumps({n: v for n, v in
                                         pipe_spills.items() if v}))
            print("  ptxas direct store vs SLOT_WORD_CARRY (registers min, "
                  "max):", json.dumps(carry_registers(regs)))
        # the host codecs timed below must be the native library's
        print(f"native host codecs loaded: {native.available()}")
        if not native.available():
            raise RuntimeError("the port's native host library did not "
                               "build or load (g++ into "
                               "fdreadoutlibs_tpu_torch/_build/)")

    with phase("3 kernel vs plain"):
        kernels = kernel_vs_plain(dev)
        sm_mhz = sm_clock_mhz()
        print(f"  SM clock after the timing loops: {sm_mhz} MHz")

    with phase("4 apa slice"):
        app_launches, apa_data = apa_slice(dev)

    with phase("5 wib2 slice"):
        t0 = time.perf_counter()
        batches, checked = [], []
        for b in range(1 + WIB2_TIMED):
            sc, adcs = wib2_superchunks(
                WIB2_LINKS, WIB2_SC, seed=SEED + b,
                ts0=0x1000000 + b * WIB2_SC * wib2.SUPERCHUNK_TICK_DIFFERENCE)
            batches.append(sc)
            if b < N_CHECKED:
                checked.append(adcs)
        print(f"  data: {len(batches)} batches of {WIB2_LINKS} x {WIB2_SC} "
              f"superchunks in {time.perf_counter() - t0:.3f} s")
        plain = []
        packed = wib2_slice(False, batches, checked, plain, dev)
        time2 = wib2_slice(True, batches, checked, plain, dev)
        del batches, checked

    with phase("6 protowib slice"):
        pw = protowib_slice(dev)

    with phase("7 kernel entries"):
        entries = kernel_entries(dev)

    with phase("8 probes"):
        probe_rows, ceiling, pipe_rows = probes_phase(dev, kernels)

    with phase("9 detector slice"):
        det = detector_slice(dev)

    with phase("10 modules slice"):
        mods = modules_slice(dev, apa_data)

    with phase("11 parallel slice"):
        par = parallel_slice(dev, apa_data)
    print("  launches on the main paths of phases 1-11, per kernel "
          "function:", json.dumps(function_launches))

    with phase("12 tool slice"):
        tools = tool_slice(dev, apa_data)

    with phase("13 bench"):
        bench_launches = bench_phase(dev)

    # launches on the main paths: the APA app's feeds, the WIB2 and the
    # ProtoWIB processors' runs, the kernel entries, the detector slice,
    # the modules slice (scheduler, entry(), CLI, resume).  A row counts its
    # kernel function's launches (tally); the launches of every kernel on
    # a launch's datapath (tpg.kernels_of: a FIR launch on plain samples is
    # K2's datapath and K3's family) stand beside them
    datapath = {
        "K1": app_launches["time2"],
        "K2": app_launches["packed"] + packed["K2"] + pw["K2"]
        + entries["K2"] + det["K2"],
        "K3": packed["K3"] + time2["K3"] + pw["K3"],
        "K4": app_launches["fused"] + app_launches["words14"] + det["K4"],
        "K5": pw["K5"],
        **{k: entries[k] for k in ("K2b", "K3b", "K4b-slab", "K4b-gather")}}
    for k, v in (list(mods.items()) + list(par.items()) + list(tools.items())
                 + list(bench_launches.items())):
        datapath[k] += v
    print("  launches on the main paths, per kernel function:",
          json.dumps(function_launches), "per datapath:", json.dumps(datapath))
    rows = []
    for k in KERNELS:
        bound_ms, bound_by = bound(kernels[k]["work"], sm_mhz, ceiling)
        row = {"name": f"tpg {k} ({kernels[k]['timed']})", "route": "cuda",
               "source": SOURCE, "replaces": REPLACES[k],
               "launches": function_launches[k],
               "max_abs_err": kernels[k]["max_abs_err"],
               "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "datapath_launches": datapath[k],
               **pipe_rows.get(k, {})}
        if kernels[k].get("base"):
            row["varies"], row["varies_ms_same_inputs"] = kernels[k]["base"]
        if function_launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on a main path")
        rows.append(row)
    print(smi)
    print(json.dumps({"kernels": rows + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
