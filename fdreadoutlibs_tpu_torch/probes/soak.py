"""Hardware soak: a production configuration (default AbsRS with
threshold-on-collection; --alg FIR runs the FIR family) over a long
carried-state stream, with a mid-stream checkpoint/resume equivalence
check.

Counterpart of ``scripts/soak_hardware.py:1-226``, with its arguments and
its JSON line.  Runs N windows of T ticks x C channels through the TPG
kernel with deterministic injected pulses, in one of four ingests: plain
samples (K2), ``--fused`` (the frame words, K4), ``--words14-feed`` (the
host's words14 relayout, K4) or ``--time2-feed`` (the host's time2
relayout, K1; K3 carries FIR on every ingest).  Asserts (a) the exact
expected hit count (every pulse found, nothing dropped, nothing invented;
the numpy oracle on the 8 pulse channels, :68-90), (b) a run that
checkpoints at the midpoint through host numpy and resumes in a fresh
state tensor ends bit-identical to the uninterrupted run (:191-199).
Prints one JSON line, then ``SOAK OK``.

Each window's slots are fetched and decoded on the host
(``ops/ingest.decode_slots``, lossless), as the JAX script decodes them
with ``decode_pallas_hits``; tc 512 and 2 slots a chunk as there.

Usage: python -m fdreadoutlibs_tpu_torch.probes.soak [--windows 200]
[--ticks 4096] [--device cuda]  (``--device cpu``: the plain versions)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import native
from ..formats import wibeth
from ..ops import TPGConfig, init_chanstate, seed_chanstate
from ..ops.ingest import (decode_slots, process_packed_frames_fused,
                          process_time2_feed, process_words14_feed)
from ..ops.reference import process_window_reference
from ..ops.tpg import pack_state, process_window

INGESTS = ("plain", "fused", "words14", "time2")
TC, K_SLOTS = 512, 2
PULSE_CHANS = np.array([5, 300, 777, 1201, 1600, 1999, 2222, 2500])


def make_stream(T: int, C: int, alg: str):
    """(cfg, adcs (T, C) int32, rmf (C,), pulse channels): the script's
    window (:60-75), the same every window."""
    if alg == "FIR":
        cfg = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
        rmf = np.full(C, cfg.rs_memory_factor_x10)
    else:
        cfg = TPGConfig.from_raw(alg, threshold=150)
        rmf = np.where(np.arange(C) % 8 < 3, 0, cfg.rs_memory_factor_x10) \
            if alg == "AbsRS" else np.full(C, cfg.rs_memory_factor_x10)
    rng = np.random.default_rng(42)
    base = (900 + rng.normal(0, 10, size=(T, C))).astype(np.int32)
    # deterministic pulses: one clean pulse per window on each channel
    # (those below C), amplitude far above noise and the RS decay tail
    pulse_chans = PULSE_CHANS[PULSE_CHANS < C]
    adcs = base.copy()
    for c in pulse_chans:
        adcs[1000:1008, c] += 2500
    return cfg, adcs, rmf, pulse_chans


def oracle(cfg: TPGConfig, adcs: np.ndarray, rmf, pulse_chans) -> list:
    """Hits per window of the numpy oracle on the pulse channels alone
    (channels are independent, :77-90) for windows 0-2; windows 1 and 2
    must agree (steady state)."""
    sub = adcs[:, pulse_chans]
    st = seed_chanstate(init_chanstate(len(pulse_chans)), sub[0],
                        np.asarray(rmf)[pulse_chans])
    per_window = []
    for _ in range(3):
        h, st = process_window_reference(sub, st, cfg)
        per_window.append(len(h))
    assert per_window[1] == per_window[2], \
        "oracle not steady-state by window 2"
    return per_window


def _host_words(adcs: np.ndarray) -> np.ndarray:
    """(T, C) ADCs -> (L, T, 28) uint32 WIBEth frame words (:107-118)."""
    T, C = adcs.shape
    if C % wibeth.N_CHANNELS or T % wibeth.N_TIME_SAMPLES:
        raise ValueError("the frame ingests need whole frames: C % 64 == 0 "
                         "and T % 64 == 0")
    L, n_frames = C // wibeth.N_CHANNELS, T // wibeth.N_TIME_SAMPLES
    frames = wibeth.empty_frames(L * n_frames)
    a = adcs.reshape(n_frames, wibeth.N_TIME_SAMPLES, L,
                     wibeth.N_CHANNELS).transpose(2, 0, 1, 3)
    wibeth.set_adcs(frames, a.reshape(L * n_frames, wibeth.N_TIME_SAMPLES,
                                      wibeth.N_CHANNELS).astype(np.uint16))
    return wibeth.frames_bytes_to_u32(frames).reshape(L, T, 28)


def make_step(cfg: TPGConfig, adcs: np.ndarray, ingest: str, device):
    """step(state) -> (slots, nclose, new_state): one window through the
    ingest's entry, the feed uploaded once."""
    C = adcs.shape[1]
    kw = dict(tc=TC, k_slots=K_SLOTS)
    if ingest == "plain":
        feed = torch.from_numpy(adcs).to(device)
        return lambda st: process_window(feed, st, cfg, time_packed=False,
                                         **kw)
    words = _host_words(adcs)
    if ingest == "fused":
        feed = torch.from_numpy(words.view(np.int32)).to(device)
        return lambda st: process_packed_frames_fused(feed, st, cfg, C, **kw)
    if ingest == "words14":
        # the host/NIC-side relayout (the C++ codec): kernel-ordered rows
        feed = torch.from_numpy(native.relayout_words14(words)).to(device)
        return lambda st: process_words14_feed(feed, st, cfg, C, **kw)
    if ingest == "time2":
        # unpadded rows, as the production app ships them
        feed = torch.from_numpy(
            native.relayout_time2(words, pad8=False)).to(device)
        return lambda st: process_time2_feed(feed, st, cfg, C, **kw)
    raise ValueError(f"unknown ingest {ingest!r}; one of {INGESTS}")


def run(windows: int = 200, ticks: int = 4096, channels: int = 2560,
        alg: str = "AbsRS", ingest: str = "plain", device="cuda") -> dict:
    """The soak; returns the script's JSON record (plus ``ingest`` and
    ``device``).  Raises AssertionError where the script asserts."""
    from ..apps.apa_readout import resolve_device
    dev = resolve_device(device)
    C, T, W = channels, ticks, windows
    cfg, adcs, rmf, pulse_chans = make_stream(T, C, alg)
    per_window = oracle(cfg, adcs, rmf, pulse_chans)

    def expected_total(n):
        return per_window[0] + (n - 1) * per_window[1]

    state0 = pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C,
                        device=dev)
    step = make_step(cfg, adcs, ingest, dev)

    def soak(state, n_windows):
        hits_total = dropped_total = 0
        for _ in range(n_windows):
            slots, nclose, state = step(state)
            h, d = decode_slots(slots, nclose, C)
            hits_total += len(h)
            dropped_total += d
        return state, hits_total, dropped_total

    t0 = time.perf_counter()
    final_a, hits_a, drop_a = soak(state0, W)
    # checkpointed run: halt at the midpoint, round-trip the state through
    # host numpy (the checkpoint format), resume in a fresh tensor
    mid, hits_b1, _ = soak(state0, W // 2)
    ckpt = mid.cpu().numpy()
    resumed = torch.from_numpy(ckpt.copy()).to(dev)
    final_b, hits_b2, _ = soak(resumed, W - W // 2)
    wall = time.perf_counter() - t0
    same = bool(torch.equal(final_a.cpu(), final_b.cpu()))
    return {
        "windows": W, "ticks": T, "channels": C, "ingest": ingest,
        "device": str(dev), "gsamples": round(W * T * C / 1e9, 2),
        "data_seconds": round(W * T / (62.5e6 / 32), 2),
        "wall_seconds": round(wall, 1),
        "hits": hits_a, "expected": expected_total(W), "dropped": drop_a,
        "resume_hits": hits_b1 + hits_b2,
        "state_bitexact_after_resume": same,
    }


def check(result: dict) -> None:
    """The script's assertions (:216-220)."""
    assert result["state_bitexact_after_resume"], "resumed state diverged"
    assert result["hits"] == result["resume_hits"], \
        "resumed run found different hits"
    assert result["dropped"] == 0, f"{result['dropped']} hits dropped"
    assert result["hits"] == result["expected"], \
        f"hits {result['hits']} != expected {result['expected']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--ticks", type=int, default=4096)
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--alg", default="AbsRS",
                    choices=["AbsRS", "SimpleThreshold", "StandardRS",
                             "FIR"])
    ap.add_argument("--fused", action="store_true",
                    help="soak the fused byte-ingest path (in-kernel "
                         "unpack of the frame words, K4)")
    ap.add_argument("--words14-feed", action="store_true",
                    help="soak the words14 feed: host C++ relayout "
                         "(native.relayout_words14) -> the in-kernel "
                         "unpack (K4)")
    ap.add_argument("--time2-feed", action="store_true",
                    help="soak the time2 feed: host C++ unpack + pairing "
                         "(native.relayout_time2) -> the time2 datapath")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    ingest = "words14" if args.words14_feed else "fused" if args.fused \
        else "time2" if args.time2_feed else "plain"
    result = run(args.windows, args.ticks, args.channels, args.alg, ingest,
                 args.device)
    print(json.dumps(result))
    check(result)
    print("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
