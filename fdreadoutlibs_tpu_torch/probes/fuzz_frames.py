"""Malformed-frame fuzz — counterpart of ``scripts/fuzz_frames.py``.

Random corrupt streams through every frame processor of the port: bit
flips in DAQ headers and in the packed ADC words, zeroed and all-ones
payloads (every sample 16383), duplicated and reordered payloads, timestamp
and sequence jumps, and truncated payload files.  The rigs are copies of
the JAX script's (:41-390: WIBEth, WIB2, ProtoWIB, DAPHNE-stream, DAPHNE
self-triggered, TDE and SSP), on the port's formats and processors.  Per
case (:12-20):

1. no exception escapes the processor;
2. an injected timestamp discontinuity that must be seen is seen: the
   processor's error metrics or its ``FrameErrorRegistry`` record it;
3. for the formats with a TPG the whole corrupt stream goes through two
   backends, the processor's ``"pallas"`` backend (the CUDA kernel on the
   card; on ``device="cpu"`` its plain version) and ``"reference"`` (the
   numpy oracle), and the two TP streams are equal, every batch after the
   corruption included, but for what the kernel's contract says: closes
   beyond its K slots a chunk are dropped and counted
   (``num_hits_dropped``; TDE's windows count none, so its TPs must be a
   part of the reference stream), and its hit record holds the charge and
   the peak in 16 bits (:func:`record_view`).  On the card the kernel's TP
   stream and drops must also equal its plain version's, bit for bit.

``python -m fdreadoutlibs_tpu_torch.probes.fuzz_frames --n 100 --start
50000`` on the card (``--per-rig N`` draws N seeds for each rig instead);
``--device cpu`` runs the plain version in the kernel's place.  Without a
card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from ..ops import tpg


def tpg_launches() -> dict:
    """The tpg kernel launches so far, per kernel function."""
    return dict(tpg.process_window.function_launches)


# --------------------------------------------------------------- format rigs

class Rig:
    """One processor family: build a valid stream, corrupt it, drive it."""

    name = ""
    frame_size = 0
    header_bytes = 0          # leading per-payload header region to bit-flip
    dual_backend = True       # pallas-vs-reference TP parity
    has_seq = False           # format carries a sequence counter
    checks_ts = True          # processor runs a timestamp-continuity check
    counts_drops = True       # "pallas" counts the closes beyond its slots

    def build(self, rng, n_payloads):
        """-> payloads uint8 (n, frame_size-multiple)"""
        raise NotImplementedError

    def ts_assertable(self, chosen, ts_jump_idx):
        """Whether injected ts discontinuities are guaranteed observable
        (override where per-channel bookkeeping weakens the guarantee)."""
        return self.checks_ts

    def make_proc(self, backend, device):
        """-> (processor, drain() -> list of TP arrays)"""
        raise NotImplementedError

    def set_ts(self, payloads, idx, value):
        raise NotImplementedError

    def set_seq(self, payloads, idx, value):
        raise NotImplementedError


class WIBEthRig(Rig):
    name = "wibeth"
    has_seq = True

    def __init__(self):
        from ..formats import wibeth
        self.f = wibeth
        self.frame_size = wibeth.FRAME_SIZE
        self.header_bytes = 8 * wibeth.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 64, 64))) \
            .astype(np.uint16)
        # a couple of genuine pulses so the TP path is exercised
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(64)
            t = rng.integers(50)
            adcs[p, t:t + 8, c] += 2500
        f.set_adcs(frames, adcs)
        f.fake_timestamps(frames, 10_000)
        f.fake_seq_ids(frames, 1)
        f.fake_geoid(frames, 1, 2, 3)
        return frames

    def make_proc(self, backend, device):
        from ..stream import WIBEthFrameProcessor
        from ..stream.transport import QueueSender
        sink = QueueSender()
        proc = WIBEthFrameProcessor(tp_sink=sink, device=device)
        proc.conf({"crate_id": 1, "slot_id": 2, "link_id": 3,
                   "enable_tpg": True, "tpg_algorithm": "AbsRS",
                   "tpg_threshold": 300, "tp_timeout": 100_000,
                   "tpg_backend": backend,
                   "channel_map_name": "HDAPAChannelMap"})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)

    def set_seq(self, payloads, idx, value):
        self.f.set_header_field(payloads[idx:idx + 1], "seq_id", value)


class WIB2Rig(Rig):
    name = "wib2"

    def __init__(self):
        from ..formats import wib2
        self.f = wib2
        self.frame_size = wib2.SUPERCHUNK_SIZE
        self.header_bytes = 4 * wib2.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 12, 256))) \
            .astype(np.uint16)
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(256)
            adcs[p, :, c] += 2500
        f.set_adcs(frames.reshape(-1, f.FRAME_SIZE),
                   adcs.reshape(-1, 256))
        f.fake_timestamps(sc, 50_000)
        f.fake_geoid(sc, 0, 0, 0)
        return sc

    def make_proc(self, backend, device):
        from ..stream import WIB2FrameProcessor
        from ..stream.transport import QueueSender
        sink = QueueSender()
        proc = WIB2FrameProcessor(tp_sink=sink, device=device)
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_algorithm": "FIR",
                   "tpg_threshold": 300, "tp_timeout": 100_000,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames.reshape(-1, self.f.FRAME_SIZE), value)


class ProtoWIBRig(Rig):
    name = "protowib"

    def __init__(self):
        from ..formats import protowib
        self.f = protowib
        self.frame_size = protowib.SUPERCHUNK_SIZE
        self.header_bytes = protowib.HEADER_BYTES

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 12, 256))) \
            .astype(np.uint16)
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(256)
            adcs[p, :, c] += 1500
        f.set_adcs(frames, adcs.reshape(n_payloads, 12, 256))
        f.fake_timestamps(sc, 50_000)
        return sc

    def make_proc(self, backend, device):
        from ..stream.protowib import WIBFrameProcessor
        from ..stream.transport import QueueSender
        from ..tp.wib_tp_handler import WIBTPHandler
        tp_q = QueueSender()
        handler = WIBTPHandler(tp_sink=tp_q, tpset_sink=QueueSender(),
                               tp_timeout=100_000, tpset_window_size=2_000)
        proc = WIBFrameProcessor(tp_handler=handler,
                                 errored_frame_sink=QueueSender(),
                                 device=device)
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_backend": backend})
        proc.start()
        return proc, tp_q.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames, value)


class DAPHNEStreamRig(Rig):
    name = "daphne_stream"

    def __init__(self):
        from ..formats import daphne
        self.f = daphne
        self.frame_size = daphne.STREAM_SUPERCHUNK_SIZE
        self.header_bytes = 4 * daphne.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads, stream=True)
        frames = f.superchunk_frames(sc, stream=True) \
            .reshape(-1, f.STREAM_FRAME_SIZE)
        n_frames = frames.shape[0]
        adcs = (900 + rng.normal(
            0, 30,
            size=(n_frames, f.STREAM_N_SAMPLES, f.STREAM_N_CHANNELS))) \
            .astype(np.uint16)
        for _ in range(2):
            fr, c = rng.integers(n_frames), rng.integers(f.STREAM_N_CHANNELS)
            adcs[fr, 20:40, c] += 1500
        f.stream_set_adcs(frames, adcs)
        f.fake_timestamps(sc, 30_000, stream=True)
        return sc

    def make_proc(self, backend, device):
        from ..stream.daphne import DAPHNEStreamFrameProcessor
        from ..stream.transport import QueueSender
        sink = QueueSender()
        proc = DAPHNEStreamFrameProcessor(tp_sink=sink, device=device)
        proc.conf({"enable_tpg": True, "tpg_threshold": 300,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1], stream=True)
        self.f.stream_set_timestamp(
            frames.reshape(-1, self.f.STREAM_FRAME_SIZE), value)


class DAPHNERig(Rig):
    """Self-triggered PDS superchunks (12 x 1816 B) ->
    ``DAPHNEFrameProcessor``'s numpy pulse analysis: one TPG path (no
    backend pair) and no timestamp assertion (the check is informational
    for the self-triggered stream)."""

    name = "daphne"
    dual_backend = False
    checks_ts = False

    def __init__(self):
        from ..formats import daphne
        self.f = daphne
        self.frame_size = daphne.SUPERCHUNK_SIZE
        self.header_bytes = 4 * daphne.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc).reshape(-1, f.FRAME_SIZE)
        n_frames = frames.shape[0]
        wfs = (900 + rng.normal(0, 30, size=(n_frames, f.N_SAMPLES))) \
            .astype(np.uint16)
        for _ in range(3):
            fr = rng.integers(n_frames)
            t = rng.integers(f.N_SAMPLES - 60)
            wfs[fr, t:t + 30] += 1500
        f.set_waveform(frames, wfs)
        f.set_header_field(frames, "link_id",
                           np.arange(n_frames, dtype=np.uint32) % 4)
        f.fake_timestamps(sc, 40_000)
        return sc

    def make_proc(self, backend, device):
        from ..stream.daphne import DAPHNEFrameProcessor
        from ..stream.transport import QueueSender
        sink = QueueSender()
        proc = DAPHNEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 300})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames.reshape(-1, self.f.FRAME_SIZE), value)


class TDERig(Rig):
    """``run_model``'s "pallas" windows keep 8 closes a channel each
    (``models/algorithms.K_SLOTS``) and count none beyond them, in both
    packages: check 3 holds its TPs to a part of the reference stream."""

    name = "tde"
    counts_drops = False

    def __init__(self):
        from ..formats import tde
        self.f = tde
        self.frame_size = tde.FRAME_SIZE
        self.header_bytes = tde.HEADER_BYTES

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        samples = (900 + rng.normal(
            0, 30, size=(n_payloads, f.TOT_ADC16_SAMPLES))).astype(np.uint16)
        for _ in range(2):
            p = rng.integers(n_payloads)
            t = rng.integers(f.TOT_ADC16_SAMPLES - 40)
            samples[p, t:t + 20] += 1500
        f.set_adc_samples(frames, samples)
        f.fake_timestamps(frames, 20_000)
        f.set_channel(frames, np.arange(n_payloads) % 4)
        f.fake_geoid(frames, 0, 0, 0)
        return frames

    def make_proc(self, backend, device):
        from ..stream import TDEFrameProcessor
        from ..stream.transport import QueueSender
        sink = QueueSender()
        proc = TDEFrameProcessor(tp_sink=sink, device=device)
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_threshold": 300,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)

    def ts_assertable(self, chosen, ts_jump_idx):
        """TDE tracks continuity per channel: a jump on a channel's first
        frame becomes its baseline, and corruptions that rewrite the
        header's channel field scramble which frame is first, so only the
        clean single ts_jump past the first channel cycle is asserted
        (build() assigns channels arange(n) % 4)."""
        fragile = {"zero_payload", "ones_payload", "bitflip_header",
                   "dup_payload", "reorder"}
        if set(chosen) & fragile:
            return False
        return ts_jump_idx is None or ts_jump_idx >= 4


class SSPRig(Rig):
    name = "ssp"
    dual_backend = False
    checks_ts = False         # SSP has no continuity check

    def __init__(self):
        from ..formats import ssp
        self.f = ssp
        self.frame_size = ssp.FRAME_SIZE
        self.header_bytes = ssp.HEADER_SIZE

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        f.set_waveform(frames, (900 + rng.normal(
            0, 30, size=(n_payloads, f.PAYLOAD_SIZE // 2))).astype(np.uint16))
        f.set_timestamp(frames, 40_000 + 100 * np.arange(n_payloads))
        return frames

    def make_proc(self, backend, device):
        from ..stream import SSPFrameProcessor
        proc = SSPFrameProcessor()
        proc.conf({})
        proc.start()
        return proc, lambda: []

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)


RIGS = (WIBEthRig, WIB2Rig, ProtoWIBRig, DAPHNEStreamRig, DAPHNERig, TDERig,
        SSPRig)


# ------------------------------------------------------------- corruptions

def corrupt(rig, payloads, rng):
    """Apply 1-3 random corruptions in place; return (names, deterministic)
    where deterministic notes whether a guaranteed-observable ts/seq
    discontinuity was injected on a non-first payload (:401-467)."""
    n = len(payloads)
    raw = payloads.reshape(n, -1).view(np.uint8)
    kinds = ["bitflip_header", "bitflip_adc", "zero_payload", "ones_payload",
             "dup_payload", "ts_jump", "reorder"]
    if rig.has_seq:
        kinds.append("seq_jump")
    chosen = list(rng.choice(kinds, size=int(rng.integers(1, 4)),
                             replace=False))
    deterministic_ts = False
    ts_jump_idx = None
    for kind in chosen:
        idx = int(rng.integers(n))
        if kind == "bitflip_header":
            for _ in range(int(rng.integers(1, 17))):
                b = int(rng.integers(rig.header_bytes))
                raw[idx, b] ^= np.uint8(1 << int(rng.integers(8)))
        elif kind == "bitflip_adc":
            lo = rig.header_bytes
            for _ in range(int(rng.integers(1, 65))):
                b = int(rng.integers(lo, raw.shape[1]))
                raw[idx, b] ^= np.uint8(1 << int(rng.integers(8)))
        elif kind == "zero_payload":
            raw[idx] = 0
        elif kind == "ones_payload":
            raw[idx] = 0xFF
        elif kind == "dup_payload":
            if n >= 2:
                j = int(rng.integers(n - 1)) + 1
                raw[j] = raw[j - 1]
                if rig.checks_ts:
                    deterministic_ts = True   # duplicate ts breaks continuity
        elif kind == "reorder":
            # network reordering: swap two adjacent payloads past the
            # first, a backward ts delta the continuity check must see
            if n >= 3:
                j = int(rng.integers(1, n - 1))
                tmp = raw[j].copy()
                raw[j] = raw[j + 1]
                raw[j + 1] = tmp
                if rig.checks_ts:
                    deterministic_ts = True
        elif kind == "ts_jump":
            if idx == 0:
                idx = min(1, n - 1)
            if idx > 0:
                # full uint64 range: headers can carry any 64-bit garbage
                hi = int(rng.integers(0, 2**62)) * 4 + 2
                rig.set_ts(payloads, idx, hi | 1)
                ts_jump_idx = idx
        elif kind == "seq_jump":
            if idx == 0:
                idx = min(1, n - 1)
            if idx > 0:
                rig.set_seq(payloads, idx, int(rng.integers(4096)))
                # a random seq may equal the expected one: no assertion
    if ts_jump_idx is not None and rig.checks_ts:
        deterministic_ts = True
    if not rig.ts_assertable(chosen, ts_jump_idx):
        deterministic_ts = False
    return chosen, deterministic_ts


def drive(rig, payloads, bounds, backend, device="cpu"):
    """The payloads through a fresh processor in the batches of
    ``bounds``: (processor, the TPs concatenated or None)."""
    proc, drain = rig.make_proc(backend, device)
    for a, b in zip(bounds[:-1], bounds[1:]):
        proc.process(payloads[a:b].copy())
    tps = drain()
    tps = np.concatenate(tps) if tps else None
    return proc, tps


def truncated_file_case(rng):
    """``FileSourceBuffer`` drops a partial tail payload and rejects a file
    without a whole payload (:481-508)."""
    from ..stream.emulator import FileSourceBuffer
    size = int(rng.integers(64, 8192))
    n_whole = int(rng.integers(0, 4))
    tail = int(rng.integers(1, size))
    data = rng.integers(0, 256, size=n_whole * size + tail, dtype=np.uint8)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tf:
        data.tofile(tf)
        path = tf.name
    try:
        buf = FileSourceBuffer(size)
        if n_whole == 0:
            try:
                buf.read(path)
                return "no-complete-payload file must raise"
            except ValueError:
                return None
        got = buf.read(path)
        if got.shape != (n_whole, size):
            return f"truncated read shape {got.shape} != ({n_whole},{size})"
        if not np.array_equal(got.reshape(-1), data[:n_whole * size]):
            return "truncated read bytes differ"
        return None
    finally:
        os.unlink(path)


def record_view(tps):
    """The TPs with adc_integral and adc_peak as the kernel's hit record
    holds them, in signed 16 bits (charge << 16 | tover, peak << 16 |
    ptime): the "pallas" backend of both packages decodes a charge or a
    peak above 32767 wrapped, where "reference" keeps 32 bits (ROADMAP.md
    section 3).  Values that fit are unchanged."""
    out = np.array(tps, copy=True)
    for f in ("adc_integral", "adc_peak"):
        v = out[f].astype(np.int64)
        out[f] = ((v + (1 << 15)) % (1 << 16) - (1 << 15)).astype(
            out.dtype[f])
    return out


def tp_mismatch(got, want, dropped):
    """Why the "pallas" TP stream ``got`` is not the "reference" stream
    ``want`` less the ``dropped`` closes the processor counted beyond the
    kernel's K slots a chunk (compared as :func:`record_view` holds them),
    or None.  ``dropped`` None: the processor counts no drop, and ``got``
    must be a part of ``want``."""
    if got is None and want is None:
        return None if not dropped else f"{dropped} dropped, no TPs"
    dtype = (got if got is not None else want).dtype
    got = record_view(got if got is not None else np.zeros(0, dtype))
    want = record_view(want if want is not None else np.zeros(0, dtype))
    if dropped is None:
        dropped = len(want) - len(got)
        if dropped < 0:
            return f"TP count pallas={len(got)} > ref={len(want)}"
    if len(want) - len(got) != dropped:
        return (f"TP count pallas={len(got)} ref={len(want)} with "
                f"{dropped} dropped")
    if not dropped:
        return None if np.array_equal(got, want) else \
            "TP streams diverge between backends"
    left = collections.Counter(want.tolist())
    left.subtract(got.tolist())
    if any(v < 0 for v in left.values()):
        return "a pallas TP is not in the reference stream"
    return None


def errors_seen(proc) -> int:
    """The timestamp errors a processor recorded: its metric and its
    registry's entries."""
    return proc.metrics.count("num_ts_errors") + \
        proc.error_registry.error_count()


def run_case(rigs, seed: int, device, rig=None) -> dict:
    """One seed (:511-550): the rig drawn from the seed (or ``rig``, a
    name), its payloads, corruptions and batch split; the stream through
    the "pallas" backend on ``device`` and, for the TPG formats, through
    "reference".  Returns {"seed", "rig", ..., "error": None or why}."""
    rng = np.random.default_rng(seed)
    if rig is None:
        if rng.random() < 0.1:
            err = truncated_file_case(rng)
            return {"seed": seed, "rig": "file_truncation", "error": err,
                    "errors_seen": 0}
        r = rigs[int(rng.integers(len(rigs)))]
    else:
        r = next(x for x in rigs if x.name == rig)
    n = int(rng.integers(4, 9))
    payloads = r.build(rng, n)
    kinds, deterministic_ts = corrupt(r, payloads, rng)
    # random batch split (state must carry across corrupt boundaries)
    cuts = sorted(rng.choice(np.arange(1, n), size=min(2, n - 1),
                             replace=False).tolist())
    bounds = [0] + cuts + [n]
    case = {"seed": seed, "rig": r.name, "corruptions": kinds,
            "error": None, "errors_seen": 0, "tps": 0, "dropped": 0}
    try:
        proc, tps = drive(r, payloads, bounds, "pallas"
                          if r.dual_backend else "reference", device)
        case["errors_seen"] = errors_seen(proc)
        case["tps"] = 0 if tps is None else len(tps)
        case["dropped"] = proc.metrics.count("num_hits_dropped")
        if deterministic_ts and not case["errors_seen"]:
            case["error"] = "deterministic ts corruption not observed"
            return case
        if not r.dual_backend:
            return case
        if torch.device(device).type != "cpu":
            # the kernel against its plain version: the same TPs and drops
            plain, tps_plain = drive(r, payloads, bounds, "pallas", "cpu")
            if plain.metrics.count("num_hits_dropped") != case["dropped"] \
                    or (tps is None) != (tps_plain is None) or (
                        tps is not None
                        and not np.array_equal(tps, tps_plain)):
                case["error"] = "the kernel's TPs differ from the plain " \
                    "version's"
                return case
        _, tps_ref = drive(r, payloads, bounds, "reference", device)
        case["error"] = tp_mismatch(tps, tps_ref, case["dropped"]
                                    if r.counts_drops else None)
    except Exception:  # noqa: BLE001 — check 1: nothing escapes
        case["error"] = traceback.format_exc(limit=8)
    return case


def sweep(n: int = 0, start: int = 50_000, device=None, per_rig: int = 0,
          log=print) -> dict:
    """``n`` seeds from ``start`` (the rig drawn from each), then
    ``per_rig`` seeds for every rig; a failing case is reported (one JSON
    line) and counted.  Returns the summary, with the TPG kernel launches
    of the run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fuzz_frames needs a CUDA card (device='cpu' "
                               "runs the plain version in its place)")
        device = "cuda:0"
    rigs = [cls() for cls in RIGS]
    jobs = [(start + i, None) for i in range(n)] + [
        (start + n + i, r.name) for r in rigs for i in range(per_rig)]
    t0 = time.perf_counter()
    before = tpg_launches()
    failures = seen = 0
    by_rig: dict[str, int] = {}
    for seed, rig in jobs:
        res = run_case(rigs, seed, device, rig)
        by_rig[res["rig"]] = by_rig.get(res["rig"], 0) + 1
        seen += res["errors_seen"]
        if res["error"] is not None:
            failures += 1
            log(json.dumps(res))
    launches = {k: v - before.get(k, 0) for k, v in tpg_launches().items()
                if v - before.get(k, 0)}
    return {"cases": len(jobs), "start": start, "failures": failures,
            "errors_seen": seen, "by_rig": by_rig, "launches": launches,
            "device": str(device),
            "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=50_000)
    ap.add_argument("--per-rig", type=int, default=0,
                    help="also N seeds for each rig")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain version in the kernel's "
                    "place")
    args = ap.parse_args(argv)
    res = sweep(args.n, args.start, args.device, args.per_rig)
    print(json.dumps(res))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
