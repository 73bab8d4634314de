"""The pipeline's two levers on the card (``csrc/tpg.cuh``,
``pipe_kernel``): K3 (the loader-and-front warp and the filter-and-hit
warp), K3b (the same with the SWAR carry, ``fir_packed``, on every feed),
K5 (a warp each for front, filter and hit), K1, K2, K4, K2b and K4b
(the threshold families on time2 rows, plain samples, packed words, int16
samples and state, and words14 rows through the gather and the slab: a
loader-and-front warp, for AbsRS a running-sum warp, and a hit warp; K4,
K4b and K2b also run FIR as K3's pipeline) against the staged arms (the asynchronous feed staging
alone: one warp copies the feed into the shared-memory ring ahead of its
chain and runs the whole fused tick),
on the same inputs, bit-equal, timed in rotated turns; and the machine code
of every warp's group loop (16 ticks): its instructions and its longest
chain of register dependences per tick.

    python fdreadoutlibs_tpu_torch/probes/fir_pipe.py [--root DIR]

prints one JSON line.  ``--root`` times the package of another checkout
instead (an earlier commit's K1-K5, K2b, K3b and K4b through
``tpg.launch_kernel``, whose arguments are the same), so that two commits
can be compared on one card in one call; the staged arms and the machine
code are this package's only.  Each case's ``digest`` (of its slots,
nclose and state) tells whether two runs gave the same outputs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

T, C, TC, K = 8192, 2560, 256, 4
SEED = 20260
# (label, family, feed, options, peaks): the feed is "plain" or "time2"
# rows, packed 14-bit "frames" or "words14" rows (K4's decode;
# "words14-gather" and "words14-slab" the K4b schedules on the same rows),
# or "int16" samples on the int16 state, of the same samples; the options
# are ``tpg.launch_kernel``'s fir_twopass (K5) or fir_packed (K3b); the
# staged arms' cases follow
TWOPASS1, TWOPASS2 = {"fir_twopass": 1}, {"fir_twopass": 2}
PACKED = {"fir_packed": True}
CASES = (("K3 FIR plain", "FIR", "plain", {}, False),
         ("K3 FIR time2", "FIR", "time2", {}, False),
         ("K3 FIR plain peaks", "FIR", "plain", {}, True),
         ("K5 FIR plain twopass 1", "FIR", "plain", TWOPASS1, False),
         ("K5 FIR plain twopass 2", "FIR", "plain", TWOPASS2, False),
         ("K2 AbsRS plain", "AbsRS", "plain", {}, False),
         ("K2 SimpleThreshold plain", "SimpleThreshold", "plain", {}, False),
         ("K4 AbsRS frames", "AbsRS", "frames", {}, False),
         ("K4 AbsRS words14", "AbsRS", "words14", {}, False),
         ("K4 FIR frames", "FIR", "frames", {}, False),
         ("K1 AbsRS time2", "AbsRS", "time2", {}, False),
         ("K1 SimpleThreshold time2", "SimpleThreshold", "time2", {}, False),
         ("K2b AbsRS int16", "AbsRS", "int16", {}, False),
         ("K2b FIR int16", "FIR", "int16", {}, False),
         ("K4 FIR words14", "FIR", "words14", {}, False),
         ("K4b-gather AbsRS", "AbsRS", "words14-gather", {}, False),
         ("K4b-gather FIR", "FIR", "words14-gather", {}, False),
         ("K4b-slab AbsRS", "AbsRS", "words14-slab", {}, False),
         ("K4b-slab FIR", "FIR", "words14-slab", {}, False),
         ("K5 FIR words14 twopass 2", "FIR", "words14", TWOPASS2, False),
         ("K5 FIR words14-gather twopass 2", "FIR", "words14-gather",
          TWOPASS2, False),
         ("K3b FIR plain", "FIR", "plain", PACKED, False),
         ("K3b FIR time2", "FIR", "time2", PACKED, False),
         ("K3b FIR plain peaks", "FIR", "plain", PACKED, True),
         ("K3b FIR frames", "FIR", "frames", PACKED, False),
         ("K3b FIR words14", "FIR", "words14", PACKED, False),
         ("K3b FIR words14-gather", "FIR", "words14-gather", PACKED, False),
         ("K3b FIR words14-slab", "FIR", "words14-slab", PACKED, False))
STAGED = (("staged FIR plain", "FIR", "plain"),
          ("staged FIR time2", "FIR", "time2"),
          ("staged AbsRS plain", "AbsRS", "plain"),
          ("staged AbsRS frames", "AbsRS", "frames"),
          ("staged AbsRS time2", "AbsRS", "time2"),
          ("staged AbsRS int16", "AbsRS", "int16"))
# the cases held to the plain version on their own feed and state, by
# family and feed (the plain rows where none is named; "int16" on the int16
# state); every case must equal its family's (the int16 state's values
# widened: 14-bit streams stay in range)
REFERENCE = {"FIR": "K3 FIR plain", "AbsRS": "K2 AbsRS plain",
             "SimpleThreshold": "K2 SimpleThreshold plain",
             "AbsRS int16": "K2b AbsRS int16", "FIR int16": "K2b FIR int16",
             "AbsRS words14-gather": "K4b-gather AbsRS",
             "AbsRS words14-slab": "K4b-slab AbsRS",
             "FIR words14-slab": "K4b-slab FIR"}
GROUP = 16                 # ticks in a group loop's body (tpg.cuh kGroup)
# launches of the staged arms' kernels (never the plain version)
launches = 0


def feed_options(feed: str) -> tuple:
    """(time_packed, packed14, options) of ``tpg.launch_kernel`` for a feed
    of :data:`CASES`."""
    layout, _, sched = feed.partition("-")
    packed14 = layout if layout in ("frames", "words14") else None
    return (feed == "time2", packed14,
            {f"words14_{sched}": True} if sched else {})


def staged_launch(feed: torch.Tensor, state: torch.Tensor, cfg, tc: int,
                  k_slots: int, time_packed: bool = True,
                  packed14: str | None = None):
    """The staged arms on CUDA tensors: ``csrc/tpg.cu::
    tpg_fir_staged_launch`` (the FIR family on plain or time2 rows, an
    int32 state) or ``tpg_threshold_staged_launch`` (the threshold families
    on time2 rows, plain samples or packed 14-bit words, ``packed14`` as
    ``tpg.process_window`` takes it, or on int16 samples and state), the
    direct store; raises on anything else.  On CPU tensors the fused
    tick's plain version (the same function).  Returns (slots, nclose,
    new_state)."""
    global launches
    from fdreadoutlibs_tpu_torch.ops import Algorithm, _build, tpg
    if feed.device.type == "cpu" and state.device.type == "cpu":
        return tpg.process_window_plain(feed, state, cfg, tc, k_slots,
                                        time_packed, packed14)
    fir = cfg.algorithm == Algorithm.FIR
    if fir and (state.dtype != torch.int32 or packed14 is not None):
        raise ValueError("the staged arms run FIR on plain or time2 rows "
                         "on an int32 state, and the threshold families on "
                         "time2 rows, plain samples, packed words or int16 "
                         "samples")
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device
            and feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("the staged arm needs contiguous feed and state on "
                         "one CUDA device")
    lib = _build.load("tpg")
    fn = lib.tpg_fir_staged_launch if fir else lib.tpg_threshold_staged_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    dev = state.device
    out = tpg._launch(fn, feed, state, cfg, tc, k_slots, time_packed,
                      packed14, dev.index if dev.index is not None
                      else torch.cuda.current_device(),
                      torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


# ---- the machine code ------------------------------------------------------

_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\d+\s+)?"
                   r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_.]+)?)\s*([^;]*);",
                   re.MULTILINE)
_FUNC = re.compile(r"^\s*Function : (\S+)", re.MULTILINE)
_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")
_PRED = re.compile(r"^!?(U?P\d+|U?PT)$")
# opcodes that write no register
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "EXIT", "BAR", "NOP",
            "WARPSYNC", "BSSY", "BSYNC", "CALL", "RET", "DEPBAR", "MEMBAR",
            "LDGDEPBAR", "ERRBAR", "CCTL", "BPT", "YIELD", "ARRIVES")
# opcodes whose first two operands are predicate results
_TWO_PRED = ("ISETP", "FSETP", "DSETP", "PSETP", "PLOP3", "HSETP2")


def _operands(text: str) -> list:
    return [o.strip() for o in text.split(",")] if text.strip() else []


def _regs(op: str, guard: str | None, ops: list):
    """(registers written, registers read) of one instruction: the first
    operand (two for the compares), a predicate right after it (a carry
    out), the register after a 64-bit result; the guard and every other
    register are read."""
    base = op.split(".")[0]
    if base in _NO_DEST or base.startswith("SYNCS") or not ops:
        dests, rest = [], ops
    else:
        n = 2 if base in _TWO_PRED else 1
        while n < len(ops) and _PRED.match(ops[n]) and base not in _TWO_PRED:
            n += 1
        dests, rest = ops[:n], ops[n:]
    written = set()
    for d in dests:
        for r in _REG.findall(d):
            written.add(r)
            if ".64" in op or ".WIDE" in op:
                if r[0] == "R" or r.startswith("UR"):
                    pre = "UR" if r.startswith("UR") else "R"
                    written.add(f"{pre}{int(r[len(pre):]) + 1}")
    read = {r for o in rest for r in _REG.findall(o)}
    if guard:
        read |= set(_REG.findall(guard))
    return written, read


def sass_kernels(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled kernel name: [(address, guard,
    opcode, operands)]}."""
    out = {}
    marks = list(_FUNC.finditer(text))
    for m, nxt in zip(marks, marks[1:] + [None]):
        body = text[m.end():nxt.start() if nxt else len(text)]
        out[m.group(1)] = [(int(a, 16), (g or "").strip() or None, op,
                            _operands(rest))
                           for a, g, op, rest in _LINE.findall(body)]
    return out


def inner_loops(insns) -> list:
    """The loops that a backward branch closes and that hold no other
    backward branch, in address order: [instructions from the target to
    the branch]."""
    spans = []
    for at, (addr, _, op, ops) in enumerate(insns):
        m = re.search(r"0x([0-9a-f]+)", ops[-1]) if op.startswith("BRA") \
            and ops else None
        if m is None or int(m.group(1), 16) > addr:
            continue
        span = [i for i in insns[:at + 1] if i[0] >= int(m.group(1), 16)]
        spans.append(span)
    return [s for s in spans
            if not any(t is not s and t[0][0] >= s[0][0]
                       and t[-1][0] < s[-1][0] for t in spans)]


def chain_length(body) -> int:
    """The longest chain of register dependences through one pass of a
    loop's body, in instructions: each instruction one step after the
    latest of the registers it reads (registers live on entry at 0).
    Memory is not followed."""
    depth: dict[str, int] = {}
    longest = 0
    for _, guard, op, ops in body:
        written, read = _regs(op, guard, ops)
        d = 1 + max((depth.get(r, 0) for r in read), default=0)
        for r in written:
            depth[r] = d
        longest = max(longest, d)
    return longest


# integer multiplies (the running sum's); IMAD's move, add and shift forms
# are not, nor an IMAD with a zero factor (a move of its addend)
_MUL_SKIP = ("MOV", "IADD", "SHL", "X")


def _is_mul(op: str, ops: list) -> bool:
    base, *mods = op.split(".")
    return base in ("IMAD", "IMUL") and not set(mods) & set(_MUL_SKIP) \
        and "RZ" not in ops[1:3]


# K4b-slab's unpack pass per 16 ticks: two words loaded and one time2 word
# stored per tick pair and lane
UNPACK_TRAFFIC = (2 * GROUP, GROUP // 2)


def group_loops(insns, min_insns: int = 6 * GROUP) -> list:
    """Every warp's group loop (an inner loop of at least ``min_insns``
    instructions: 16 ticks, that reads its stage from shared memory; not
    the int16 feed's per-lane copy at an odd stride, which loads from
    global memory and only stores to shared), and K4b-slab's unpack pass
    over 16 ticks (:data:`UNPACK_TRAFFIC`, shorter), in address order:
    {"insns", "per_tick", "chain_per_tick", "lds", "sts", "mul"}."""
    out = []
    for body in inner_loops(insns):
        bases = [op.split(".")[0] for _, _, op, _ in body]
        if "LDS" not in bases:
            continue
        traffic = (bases.count("LDS"), bases.count("STS"))
        if len(body) < min_insns and not (traffic == UNPACK_TRAFFIC
                                          and len(body) >= 2 * GROUP):
            continue
        out.append({"insns": len(body), "per_tick": len(body) / GROUP,
                    "chain_per_tick": chain_length(body) / GROUP,
                    "lds": bases.count("LDS"), "sts": bases.count("STS"),
                    "mul": sum(_is_mul(op, ops) for _, _, op, ops in body)})
    return out


# the pipeline's instantiations that the rows report, csrc/tpg.cuh::
# pipe_kernel<encoding, mode, channel, carry> with the direct store:
# (encoding, mode, channel type, its template arguments).  The FIR cases
# without peaks, AVX semantics; the threshold cases as phase 3 runs them
# (AbsRS floored; SimpleThreshold at a positive threshold, unfloored).
REPORTED = {
    "K3": (0, 1, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "K3b": (0, 1, "FirPackedChannel", "Lb0ELb0ELb1E"),
    "K1 AbsRS": (1, 4, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "K1 SimpleThreshold": (1, 4, "ThresholdChannel", "Li0ELb0ELb0ELb0ELb0E"),
    "K2b AbsRS": (5, 4, "ThresholdChannel", "Li1ELb0ELb1ELb1ELb0E"),
    "K2b FIR": (5, 1, "FirChannel", "Lb0ELb0ELb1ELb1E"),
    "K5 twopass 1": (0, 2, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "K5 twopass 2": (0, 3, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "staged": (0, 0, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "K2 AbsRS": (0, 4, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "K2 SimpleThreshold": (0, 4, "ThresholdChannel", "Li0ELb0ELb0ELb0ELb0E"),
    "K4 AbsRS": (2, 4, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "K4 FIR": (2, 1, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "staged AbsRS plain": (0, 0, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "staged AbsRS packed": (2, 0, "ThresholdChannel",
                            "Li1ELb0ELb1ELb0ELb0E"),
    "staged AbsRS time2": (1, 0, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "staged AbsRS int16": (5, 0, "ThresholdChannel", "Li1ELb0ELb1ELb1ELb0E"),
    "K4b-gather AbsRS": (3, 4, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "K4b-gather FIR": (3, 1, "FirChannel", "Lb0ELb0ELb1ELb0E"),
    "K4b-slab AbsRS": (4, 4, "ThresholdChannel", "Li1ELb0ELb1ELb0ELb0E"),
    "K4b-slab FIR": (4, 1, "FirChannel", "Lb0ELb0ELb1ELb0E"),
}
# each warp's group loop by its shared-memory traffic per 16 ticks:
# (LDS, STS) -> role, and where two roles share it (the threshold front
# and the running sum on plain and int16 samples) (LDS, STS, at least one
# multiply a tick).  The front loads a sample (two words on packed rows, one
# word per two ticks on time2 rows, the word of its sample pair on int16
# rows) and stores s (and sigma for FIR) per tick; K5's filter loads s and
# sigma and stores flags and to_add; the running sum loads s and stores
# over; the hit warps load one or two words per tick and store none (the
# slots are global); the staged arms load a sample (two words, or one per
# two ticks) and store none.  K4b-gather's front is K4's; K4b-slab's warp 0 runs the
# unpack pass (two words in, one time2 word out per tick pair) and K1's
# front on the time2 slab.
_FIR_K3 = {(16, 32): "loader + front", (32, 0): "filter + hit"}
_FIR_K5 = {(16, 32): "loader + front", (32, 32): "filter", (32, 0): "hit"}
_THR_RS = {(16, 16, False): "loader + front", (16, 16, True): "running sum",
           (32, 0): "hit"}
ROLES = {"K3": _FIR_K3, "K3b": _FIR_K3, "K5 twopass 1": _FIR_K5,
         "K5 twopass 2": _FIR_K5,
         "K1 AbsRS": {(8, 16): "loader + front", (16, 16): "running sum",
                      (32, 0): "hit"},
         "K1 SimpleThreshold": {(8, 16): "loader + front", (16, 0): "hit"},
         "K2b AbsRS": _THR_RS, "K2b FIR": _FIR_K3,
         "staged": {(16, 0): "loader + whole tick"},
         "K2 AbsRS": _THR_RS,
         "K2 SimpleThreshold": {(16, 16): "loader + front", (16, 0): "hit"},
         "K4 AbsRS": {(32, 16): "loader + front", (16, 16): "running sum",
                      (32, 0): "hit"},
         "K4 FIR": {(32, 32): "loader + front", (32, 0): "filter + hit"},
         "staged AbsRS plain": {(16, 0): "loader + whole tick"},
         "staged AbsRS packed": {(32, 0): "loader + whole tick"},
         "staged AbsRS time2": {(8, 0): "loader + whole tick"},
         "staged AbsRS int16": {(16, 0): "loader + whole tick"},
         "K4b-gather AbsRS": {(32, 16): "loader + front",
                              (16, 16): "running sum", (32, 0): "hit"},
         "K4b-gather FIR": {(32, 32): "loader + front",
                            (32, 0): "filter + hit"},
         "K4b-slab AbsRS": {UNPACK_TRAFFIC: "unpack", (8, 16): "front",
                            (16, 16): "running sum", (32, 0): "hit"},
         "K4b-slab FIR": {UNPACK_TRAFFIC: "unpack", (8, 32): "front",
                          (32, 0): "filter + hit"}}


def _role(roles: dict, loop: dict):
    key = (loop["lds"], loop["sts"])
    if key in roles:
        return roles[key]
    return roles.get(key + (loop["mul"] >= GROUP,))


def pipe_sass(sass_text: str) -> dict:
    """{label of :data:`REPORTED`: {role: group loop}}, each loop told by
    its shared-memory traffic (:data:`ROLES`; the machine code need not
    keep the warps' order); ``chain_per_tick`` of the longest role is the
    chain floor's count.  Raises unless every warp has one group loop."""
    kernels = sass_kernels(sass_text)
    out = {}
    for label, (enc, mode, channel, args) in REPORTED.items():
        needle = re.compile(rf"pipe_kernelILi{enc}ELi{mode}EN\w*?"
                            rf"{len(channel)}{channel}I{args}EELb0E")
        hits = [k for k in kernels if needle.search(k)]
        if len(hits) != 1:
            raise LookupError(f"{len(hits)} kernels match {needle.pattern}")
        roles = {_role(ROLES[label], x): x
                 for x in group_loops(kernels[hits[0]])}
        if set(roles) != set(ROLES[label].values()):
            raise LookupError(
                f"{label}: group loops of roles {list(roles)} for warps "
                f"{list(ROLES[label].values())}: " + json.dumps(
                    [{k: x[k] for k in ("insns", "lds", "sts", "mul")}
                     for x in group_loops(kernels[hits[0]])]))
        out[label] = {role: roles[role]
                      for role in dict.fromkeys(ROLES[label].values())}
    return out


def chain_floor_ms(sass: dict, cycles_per_dep_op: float, sm_mhz: float,
                   n_ticks: int = T) -> dict:
    """Per kernel: the longest chain per tick of its warps x the cycles of
    a dependent op x the ticks, over the clock, in ms."""
    return {label: max(r["chain_per_tick"] for r in roles.values())
            * cycles_per_dep_op * n_ticks / (sm_mhz * 1e3)
            for label, roles in sass.items()}


# ---- the measurement -------------------------------------------------------

def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(fn, flush: torch.Tensor, n: int) -> float:
    """Mean ms of one call by CUDA events, each after an L2 flush."""
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


def run(device=None, trials: int = 3, reps: int = 10,
        check_plain: bool = True) -> dict:
    """Every case of :data:`CASES` (and :data:`STAGED` where this package
    has the arms) at T x C: each result equal to its family's
    :data:`REFERENCE` case on the same samples (the peaks cases to the
    first one with peaks; the int16 state widened) and, with
    ``check_plain``, the :data:`REFERENCE` cases equal to the plain version
    on their own feed and state; then ms per launch (medians over
    ``trials`` of ``reps`` launches, cases in rotated order) and cycles per
    tick per thread at the SM clock read after the timing."""
    from dataclasses import replace

    from fdreadoutlibs_tpu_torch.ops import (TPGConfig, init_chanstate,
                                             seed_chanstate, tpg)
    from fdreadoutlibs_tpu_torch.ops.ingest import pack_words14
    from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                                 time2_words, tpg_stream)
    from fdreadoutlibs_tpu_torch.utils.preflight import sm_clock_mhz
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    cfgs = {"FIR": TPGConfig.from_raw("FIR", threshold=5, track_peaks=False),
            "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
            "SimpleThreshold": TPGConfig(threshold=150)}
    fir_adcs = fir_stream(T, C, TC, K, SEED)
    thr_adcs, rmf = tpg_stream(T, C, TC, K, SEED)
    inputs = {}      # family -> ({state dtype: state}, {feed: tensor})
    for fam in cfgs:
        a, m = (fir_adcs, 0) if fam == "FIR" else (thr_adcs, rmf)
        frames = torch.from_numpy(frame_words(a).view(np.int32)).to(dev)
        state = tpg.pack_state(seed_chanstate(init_chanstate(C), a[0], m), C,
                               device=dev)
        if not torch.equal(state.to(torch.int16).to(torch.int32), state):
            raise AssertionError(f"{fam}: the seeded state leaves int16")
        inputs[fam] = (
            {torch.int32: state, torch.int16: state.to(torch.int16)},
            {"plain": torch.from_numpy(a).to(dev),
             "time2": torch.from_numpy(time2_words(a)).to(dev),
             "frames": frames, "words14": pack_words14(frames),
             "int16": torch.from_numpy(a.astype(np.int16)).to(dev)})

    def feed_state(fam, feed):
        states, feeds = inputs[fam]
        return feeds[feed], states[feeds[feed].dtype]

    runs, family = {}, {}
    for label, fam, feed, options, peaks in CASES:
        cfg = replace(cfgs[fam], track_peaks=peaks)
        f, state = feed_state(fam, feed.partition("-")[0])
        time2, packed, opts = feed_options(feed)
        runs[label] = (lambda cfg=cfg, f=f, state=state, time2=time2,
                       packed=packed, opts={**opts, **options}:
                       tpg.launch_kernel(f, state, cfg, TC, K, time2, packed,
                                         **opts))
        family[label] = (fam, peaks)
    here = Path(tpg.__file__).resolve().parents[1] == \
        Path(__file__).resolve().parents[1]
    if here:
        for label, fam, feed in STAGED:
            f, state = feed_state(fam, feed)
            packed = feed if feed in ("frames", "words14") else None
            runs[label] = (lambda cfg=cfgs[fam], f=f, state=state,
                           time2=feed == "time2", packed=packed:
                           staged_launch(f, state, cfg, TC, K, time2,
                                         packed))
            family[label] = (fam, False)
    out = {"T": T, "C": C, "tc": TC, "k_slots": K, "cases": {}}
    results = {label: fn() for label, fn in runs.items()}
    torch.cuda.synchronize()
    if check_plain:
        for key, label in REFERENCE.items():
            fam, _, feed = key.partition(" ")
            f, state = feed_state(fam, (feed or "plain").partition("-")[0])
            _, packed, opts = feed_options(feed or "plain")
            plain = tpg.process_window_plain(f, state, cfgs[fam], TC, K,
                                             False, packed, **opts)
            for g, w in zip(results[label], plain):
                if not torch.equal(g, w):
                    raise AssertionError(f"{label} differs from its plain "
                                         "version")
    for label, got in results.items():
        fam, peaks = family[label]
        ref = "K3 FIR plain peaks" if peaks else REFERENCE[fam]
        for g, w in zip(got, results[ref]):
            if not torch.equal(g.to(w.dtype), w):
                raise AssertionError(f"{label} differs from {ref}")
        out["cases"][label] = {"digest": _digest(got),
                               "max_closes_per_chunk": int(got[1].max())}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    per = {label: [] for label in runs}
    for t in range(trials):
        order = list(runs) if t % 2 == 0 else list(runs)[::-1]
        for label in order:
            per[label].append(_time(runs[label], flush, reps))
    mhz = sm_clock_mhz()
    out["sm_mhz"] = mhz
    for label, ms in per.items():
        m = statistics.median(ms)
        out["cases"][label].update(
            ms=m, ms_trials=ms, cycles_per_tick=m * 1e-3 * mhz * 1e6 / T)
    out["plain_checked"] = check_plain
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose package to time (default: "
                         "this one)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--no-plain", action="store_true",
                    help="skip the plain versions' check (~30 s)")
    args = ap.parse_args(argv)
    from fdreadoutlibs_tpu_torch.ops import _build
    from fdreadoutlibs_tpu_torch.utils.preflight import (device_preflight,
                                                         nvidia_smi)
    device_preflight()
    out = {"device": nvidia_smi(), "root": str(Path(_build.PKG_DIR).parent)}
    # the machine code first: a reading that fails costs no timed work
    sass = pipe_sass(_build.sass("tpg")) if args.root is None else None
    out.update(run(trials=args.trials, check_plain=not args.no_plain))
    if sass is not None:
        out["sass"] = sass
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    # run as a file: import the package of --root (default: this checkout)
    root = Path(__file__).resolve().parents[2]
    if "--root" in sys.argv[1:-1]:
        root = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
    sys.path.insert(0, str(root))
    raise SystemExit(main())
