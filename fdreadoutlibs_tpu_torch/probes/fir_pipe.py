"""The FIR pipeline's two levers on the card (``csrc/tpg.cuh``,
``fir_pipe_kernel``): K3 (the loader-and-front warp and the filter-and-hit
warp) and K5 (a warp each for front, filter and hit) against the staged arm
(the asynchronous feed staging alone: one warp copies the feed into the
shared-memory ring ahead of its chain and runs the whole tick), on the
same inputs, bit-equal, timed in rotated turns; and the machine code of
every warp's group loop (16 ticks): its instructions and its longest chain
of register dependences per tick.

    python fdreadoutlibs_tpu_torch/probes/fir_pipe.py [--root DIR]

prints one JSON line.  ``--root`` times the package of another checkout
instead (an earlier commit's K3 and K5 through ``tpg.launch_kernel``, whose
arguments are the same), so that two commits can be compared on one card
in one call; the staged arm and the machine code are this package's only.
Each case's ``digest`` (of its slots, nclose and state) tells whether two
runs gave the same outputs.
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

import torch

T, C, TC, K = 8192, 2560, 256, 4
SEED = 20260
# (label, time2 rows, fir_twopass, peaks); the staged arm's cases follow
CASES = (("K3 FIR plain", False, 0, False), ("K3 FIR time2", True, 0, False),
         ("K3 FIR plain peaks", False, 0, True),
         ("K5 FIR plain twopass 1", False, 1, False),
         ("K5 FIR plain twopass 2", False, 2, False))
STAGED = (("staged FIR plain", False, False), ("staged FIR time2", True, False))
GROUP = 16                 # ticks in a group loop's body (tpg.cuh kGroup)
# launches of the staged arm's kernel (never the plain version)
launches = 0


def staged_launch(feed: torch.Tensor, state: torch.Tensor, cfg, tc: int,
                  k_slots: int, time_packed: bool = True):
    """The staged arm (``csrc/tpg.cu::tpg_fir_staged_launch``) on CUDA
    tensors: the FIR family on plain or time2 rows, an int32 state, the
    direct store; raises on anything else.  On CPU tensors K3's plain
    version (the same function).  Returns (slots, nclose, new_state)."""
    global launches
    from fdreadoutlibs_tpu_torch.ops import Algorithm, _build, tpg
    if feed.device.type == "cpu" and state.device.type == "cpu":
        return tpg.process_window_plain(feed, state, cfg, tc, k_slots,
                                        time_packed)
    if cfg.algorithm != Algorithm.FIR or state.dtype != torch.int32:
        raise ValueError("the staged arm runs the FIR family on an int32 "
                         "state")
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device
            and feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("the staged arm needs contiguous feed and state on "
                         "one CUDA device")
    fn = _build.load("tpg").tpg_fir_staged_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    dev = state.device
    out = tpg._launch(fn, feed, state, cfg, tc, k_slots, time_packed, None,
                      dev.index if dev.index is not None
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


def group_loops(insns, min_insns: int = 8 * GROUP) -> list:
    """Every warp's group loop (an inner loop of at least ``min_insns``
    instructions: 16 ticks) in address order: {"insns", "per_tick",
    "chain_per_tick", "lds", "sts"}."""
    out = []
    for body in inner_loops(insns):
        if len(body) < min_insns:
            continue
        ops = [op.split(".")[0] for _, _, op, _ in body]
        out.append({"insns": len(body), "per_tick": len(body) / GROUP,
                    "chain_per_tick": chain_length(body) / GROUP,
                    "lds": ops.count("LDS"), "sts": ops.count("STS")})
    return out


# the pipeline's instantiations that the rows report: (encoding, mode,
# gated, peaks, avx, carry) of csrc/tpg.cuh::fir_pipe_kernel, on plain rows
# without peaks
REPORTED = {"K3": (0, 1, 0, 0, 1, 0), "K5 twopass 1": (0, 2, 0, 0, 1, 0),
            "K5 twopass 2": (0, 3, 0, 0, 1, 0), "staged": (0, 0, 0, 0, 1, 0)}
# each warp's group loop by its shared-memory traffic per 16 ticks (plain
# rows, no peaks): (LDS, STS) -> role.  The front loads a sample and
# stores s and sigma per tick; K5's filter loads s and sigma and stores
# flags and to_add; the hit warps load two words per tick and store none
# (the slots are global); the staged arm loads a sample and stores none.
ROLES = {"K3": {(16, 32): "loader + front", (32, 0): "filter + hit"},
         "K5 twopass 1": {(16, 32): "loader + front", (32, 32): "filter",
                          (32, 0): "hit"},
         "K5 twopass 2": {(16, 32): "loader + front", (32, 32): "filter",
                          (32, 0): "hit"},
         "staged": {(16, 0): "loader + whole tick"}}


def pipe_sass(sass_text: str) -> dict:
    """{"K3" | "K5 twopass 1" | "K5 twopass 2" | "staged": {role: group
    loop}} of the reported instantiations (the FIR plain datapath without
    peaks, AVX semantics), each loop told by its shared-memory traffic
    (:data:`ROLES`; the machine code need not keep the warps' order);
    ``chain_per_tick`` of the longest role is the chain floor's count.
    Raises unless every warp has one group loop."""
    kernels = sass_kernels(sass_text)
    out = {}
    for label, args in REPORTED.items():
        needle = "fir_pipe_kernelI" + "".join(
            f"L{'i' if i < 2 else 'b'}{a}E" for i, a in enumerate(args))
        hits = [k for k in kernels if needle in k]
        if len(hits) != 1:
            raise LookupError(f"{len(hits)} kernels match {needle}")
        roles = {ROLES[label].get((x["lds"], x["sts"])): x
                 for x in group_loops(kernels[hits[0]])}
        if set(roles) != set(ROLES[label].values()):
            raise LookupError(f"{label}: group loops of roles {list(roles)} "
                              f"for warps {list(ROLES[label].values())}")
        out[label] = {role: roles[role] for role in ROLES[label].values()}
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
    has the arm) at T x C: each result equal to the first K3 case's on its
    rows and, with ``check_plain``, that one equal to the plain version;
    then ms per launch (medians over ``trials`` of ``reps`` launches, cases
    in rotated order) and cycles per tick per thread at the SM clock read
    after the timing."""
    from dataclasses import replace

    from fdreadoutlibs_tpu_torch.ops import (TPGConfig, init_chanstate,
                                             seed_chanstate, tpg)
    from fdreadoutlibs_tpu_torch.testing import fir_stream, time2_words
    from fdreadoutlibs_tpu_torch.utils.preflight import sm_clock_mhz
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    base = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    adcs = fir_stream(T, C, TC, K, SEED)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C,
                           device=dev)
    rows = {False: torch.from_numpy(adcs).to(dev),
            True: torch.from_numpy(time2_words(adcs)).to(dev)}
    runs = {}
    for label, time2, twopass, peaks in CASES:
        cfg = replace(base, track_peaks=peaks)
        runs[label] = (lambda cfg=cfg, time2=time2, twopass=twopass:
                       tpg.launch_kernel(rows[time2], state, cfg, TC, K,
                                         time2, fir_twopass=twopass))
    here = Path(tpg.__file__).resolve().parents[1] == \
        Path(__file__).resolve().parents[1]
    if here:
        for label, time2, peaks in STAGED:
            cfg = replace(base, track_peaks=peaks)
            runs[label] = (lambda cfg=cfg, time2=time2:
                           staged_launch(rows[time2], state, cfg, TC, K,
                                         time2))
    out = {"T": T, "C": C, "tc": TC, "k_slots": K, "cases": {}}
    results = {label: fn() for label, fn in runs.items()}
    torch.cuda.synchronize()
    want = results["K3 FIR plain"]
    if check_plain:
        plain = tpg.process_window_plain(rows[False], state, base, TC, K,
                                         False)
        for g, w in zip(want, plain):
            if not torch.equal(g, w):
                raise AssertionError("K3 differs from its plain version")
    for label, got in results.items():
        ref = results["K3 FIR plain peaks"] if "peaks" in label else want
        for g, w in zip(got, ref):
            if not torch.equal(g, w):
                raise AssertionError(f"{label} differs from K3")
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
                    help="skip the plain version's check (~10 s)")
    args = ap.parse_args(argv)
    from fdreadoutlibs_tpu_torch.ops import _build
    from fdreadoutlibs_tpu_torch.utils.preflight import (device_preflight,
                                                         nvidia_smi)
    device_preflight()
    out = {"device": nvidia_smi(), "root": str(Path(_build.PKG_DIR).parent)}
    out.update(run(trials=args.trials, check_plain=not args.no_plain))
    if args.root is None:
        out["sass"] = pipe_sass(_build.sass("tpg"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    # run as a file: import the package of --root (default: this checkout)
    root = Path(__file__).resolve().parents[2]
    if "--root" in sys.argv[1:-1]:
        root = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
    sys.path.insert(0, str(root))
    raise SystemExit(main())
