"""Hardware probes of the port — counterparts of the JAX package's probe
scripts, each with a hand-written Hopper kernel (``csrc/probes*.cu``, kernel
library "probes") and its plain PyTorch version beside it:

* :mod:`.roofline` (P1) — ``scripts/roofline.py``: the int32 issue rate and
  the latency of a dependent op, and the TPG kernels against that ceiling;
* :mod:`.i16_ops` (P2) — ``scripts/probe_i16_ops.py``: the one-op int16
  record and the int32 / int16 / two-per-register throughput A/B;
* :mod:`.swar_frugal` (P3) — ``scripts/bench_swar_frugal.py``: the frugal
  pedestal chain, one channel per register against two;
* :mod:`.slots_ab` — ``scripts/bench_stepform_ab.py --mode slots``: the
  direct store against the ``SLOT_WORD_CARRY`` emission layout.

:mod:`.soak` (``scripts/soak_hardware.py``) has no kernel of its own: it
runs the TPG kernels (K2, K4, K1) over a long carried-state stream with a
mid-stream resume and checks the exact hit count.

Each runs as ``python -m fdreadoutlibs_tpu_torch.probes.<name>`` on the card
and prints one JSON line.  A kernel entry takes tensors: on CUDA tensors it
launches the kernel (or raises), on CPU tensors it runs the plain version.
This module holds what they share: the launch counts, the library handle,
CUDA-event timing and the reading of ``cuobjdump -sass``.
"""

from __future__ import annotations

import ctypes
import re

import torch

from ..ops import _build

# the probes' kernels, as chip_smoke.py lists them
KERNELS = ("P1", "P2-ops", "P2-mix", "P3-unpacked", "P3-packed")
# CUDA kernel launches per probe kernel (never the plain path)
launches = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def entry(lib: ctypes.CDLL, name: str, argtypes):
    """The C entry ``name`` of a probes library with its signature set."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def library() -> ctypes.CDLL:
    """The probes' kernel library, built at first use (needs nvcc)."""
    return _build.load("probes")


def require_cuda(*tensors) -> tuple:
    """(device index, stream) of contiguous tensors on one CUDA device;
    raises on anything else (a kernel never takes a CPU tensor)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("a probe kernel needs its tensors on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("a probe kernel needs contiguous tensors")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: the one case in which an
    entry runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def max_abs_err(got, want) -> int:
    """The largest absolute difference between a kernel's outputs and its
    plain version's (a tensor or a tuple of tensors each), in int64 so
    that a wrapped int32 difference cannot read as small."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want):
        raise ValueError(f"{len(got)} outputs against {len(want)}")
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} against "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def event_ms(fn, n: int = 1) -> float:
    """Mean ms of ``fn()`` over n calls in a row, by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def rotated(items, trial: int) -> list:
    """``items`` in the order of visit of one trial: forward on even
    trials, backward on odd ones, so no arm always runs first."""
    items = list(items)
    return items if trial % 2 == 0 else items[::-1]


# ---- reading the machine code ----------------------------------------------

_FUNC = re.compile(r"^\s*Function : (\S+)", re.MULTILINE)
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?"
                   r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_.]+)?)\s*([^;]*);",
                   re.MULTILINE)
# instructions that do no arithmetic: control, moves, memory and launch
# bookkeeping (a compare, ISETP, is arithmetic: the loop's own counter adds
# one UIADD3 and one ISETP per pass)
_NOT_ALU = ("BRA", "EXIT", "NOP", "MOV", "S2R", "S2UR", "LDC", "ULDC", "LDG",
            "STG", "LD", "ST", "CS2R", "BSSY", "BSYNC", "RET", "CALL",
            "UMOV", "R2UR", "WARPSYNC", "DEPBAR", "BAR")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled kernel name: [(address,
    opcode, operands)]}."""
    out = {}
    marks = list(_FUNC.finditer(text))
    for m, nxt in zip(marks, marks[1:] + [None]):
        body = text[m.end():nxt.start() if nxt else len(text)]
        out[m.group(1)] = [(int(a, 16), op, rest.strip())
                           for a, op, rest in _INSN.findall(body)]
    return out


def find_function(functions: dict, *needles: str) -> list:
    """The instructions of the one kernel whose mangled name holds every
    needle."""
    hits = [k for k in functions if all(n in k for n in needles)]
    if len(hits) != 1:
        raise LookupError(f"{len(hits)} kernels match {needles}: {hits}")
    return functions[hits[0]]


def histogram(insns) -> dict:
    """{opcode (modifiers dropped): count}."""
    out: dict[str, int] = {}
    for _, op, _ in insns:
        base = op.split(".")[0]
        out[base] = out.get(base, 0) + 1
    return out


def loop_body(insns) -> list:
    """The instructions of the innermost loop that a backward branch
    closes: from the branch's target up to and with the branch.  The
    longest such span is the main loop (an unrolled body dwarfs any
    epilogue loop).  Raises when the kernel has no backward branch."""
    best = []
    for at, (addr, op, rest) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m is None:
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        span = [i for i in insns[:at + 1] if i[0] >= target]
        if len(span) > len(best):
            best = span
    if not best:
        raise LookupError("no backward branch: the loop was not found")
    return best


def alu_count(insns) -> int:
    """Instructions that do arithmetic or compare (not control, moves or
    memory)."""
    return sum(n for op, n in histogram(insns).items() if op not in _NOT_ALU)
