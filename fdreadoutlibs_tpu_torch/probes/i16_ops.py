"""P2: what int16 arithmetic costs on the card — counterpart of
``scripts/probe_i16_ops.py``.

    python -m fdreadoutlibs_tpu_torch.probes.i16_ops

(a) :func:`support_matrix`: the script's one-op int16 kernels (``OPS``
:63-84 and ``narrow_i16`` :96-99) on (16, 128) vectors.  The TPU's compiler
refuses some int16 ops; ``nvcc`` compiles them all, so a row records ``ok``
(the kernel's result equals the plain version's — torch int16 tensors wrap
as JAX's do) and, from the library's machine code, the instructions the op
became beyond the copy kernel's (where the sign extensions and byte
permutes land).  Beside the script's ops stand the SIMD-in-word forms on two
int16 per 32-bit register and two of Hopper's DPX forms (:data:`WORD_OPS`).

(b) :func:`throughput_ab`: ``_mix_kernel``'s compare-free chain (:118-128:
sub, sign shift, xor, and, add through 8 arrays, array j taking array j-1's
new value) for 4096 steps on the same element count in three arms, visited
in turn: int32; int16 widened and re-narrowed per op, as K2b does
(``csrc/tpg.cuh::w16``); two int16 per register (``__vsub2``,
``__vcmplts2``, ``__vadd2``).  The mix has no clip or maximum and admits no
DPX arm (P3's chain has the clip: its ``packed_minmax`` arm).  Run at the
TPG kernels' geometry (2560 elements in 20 blocks) and at a saturating one
(132 blocks of 1024 elements); the packed arm keeps the blocks and halves
their threads.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import numpy as np
import torch

from . import (alu_count, check, entry, event_ms, find_function, histogram,
               launches, library, loop_body, on_cpu, require_cuda, rotated,
               sass_functions)
from ..ops import _build
from ..utils.preflight import device_preflight

I16, I32 = torch.int16, torch.int32


def _mask16(a, b):
    """(a - b) >> 15 on int16: 0 or -1."""
    return (a - b) >> 15


# name: (plain version on tensors, input dtype, output dtype), in the order
# of csrc/probes_i16.cu::Op.  The first 18 are scripts/probe_i16_ops.py::OPS.
OPS = {
    "add": (lambda a, b: a + b, I16, I16),
    "sub": (lambda a, b: a - b, I16, I16),
    "mul": (lambda a, b: a * b, I16, I16),
    "shl_const": (lambda a, b: a << 2, I16, I16),
    "shrs_const": (lambda a, b: a >> 3, I16, I16),
    "shrs_15": (_mask16, I16, I16),
    "shr_vec": (lambda a, b: a >> (b & 3), I16, I16),
    "and": (lambda a, b: a & b, I16, I16),
    "or": (lambda a, b: a | b, I16, I16),
    "xor": (lambda a, b: a ^ b, I16, I16),
    "not": (lambda a, b: ~a, I16, I16),
    "neg": (lambda a, b: -a, I16, I16),
    "select_mask": (lambda a, b: b ^ ((a ^ b) & _mask16(a, b)), I16, I16),
    "cmpi_gt": (lambda a, b: (a > b).to(I16), I16, I16),
    "minimum": (torch.minimum, I16, I16),
    "widen_i32": (lambda a, b: a.to(I32), I16, I32),
    "mul_widen": (lambda a, b: a.to(I32) * b.to(I32), I16, I32),
    "iota_like": (lambda a, b: a + 5, I16, I16),
    "narrow_i16": (lambda a, b: (a + b).to(I16), I32, I16),
    "copy": (lambda a, b: a.clone(), I16, I16),
}


def _halves(fn):
    """A per-half op on int32 words of two int16: the halves as int16
    tensors through ``fn``, packed again."""
    def run(a, b):
        out = fn(a.view(I16), b.view(I16))
        return out.to(I16).contiguous().view(I32)
    return run


# the SIMD-in-word and DPX forms, on int32 words of two int16
WORD_OPS = {
    "vadd2": _halves(lambda a, b: a + b),
    "vsub2": _halves(lambda a, b: a - b),
    "vcmplts2": _halves(lambda a, b: -(a < b).to(I16)),
    "vcmpgts2": _halves(lambda a, b: -(a > b).to(I16)),
    "vmaxs2": _halves(torch.maximum),
    "vmins2": _halves(torch.minimum),
    # two of Hopper's DPX forms, the third operand zero: max(a, b, 0) and
    # max(a + b, 0) per half
    "vimax3_s16x2": _halves(lambda a, b: torch.clamp(torch.maximum(a, b),
                                                     min=0)),
    "viaddmax_s16x2": _halves(lambda a, b: torch.clamp(a + b, min=0)),
}
OPS.update({k: (fn, I32, I32) for k, fn in WORD_OPS.items()})
OP_NAMES = tuple(OPS)

_OP_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MIX_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def op_inputs(name: str, device="cpu", seed=None):
    """The script's (16, 128) inputs (:43-45) in the op's input type, or
    with ``seed`` values over the whole int16 range (word ops: two such
    halves per word)."""
    _, in_dt, _ = OPS[name]
    n = 16 * 128
    if seed is None:
        a = np.arange(n).reshape(16, 128) % 251
        b = (np.arange(n).reshape(16, 128) * 7) % 113 + 1
        if name in WORD_OPS:             # a second, negative half
            a, b = a | ((-a - 3) << 16), b | ((b - 60) << 16)
    else:
        rng = np.random.default_rng(seed)
        lo, hi = rng.integers(-32768, 32768, size=(2, 2, 16, 128))
        a, b = (lo & 0xFFFF) | (hi << 16) if name in WORD_OPS else lo
    np_dt = np.int16 if in_dt == I16 else np.int32
    return (torch.from_numpy(np.ascontiguousarray(a.astype(np_dt))).to(device),
            torch.from_numpy(np.ascontiguousarray(b.astype(np_dt))).to(device))


def op_plain(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of one op."""
    fn, _, out_dt = OPS[name]
    out = fn(a, b)
    if out.dtype != out_dt:
        raise TypeError(f"{name}: the plain version gave {out.dtype}, not "
                        f"{out_dt}")
    return out


def op_launch(lib, name: str, a: torch.Tensor, b: torch.Tensor,
              device: int = 0, stream=None) -> torch.Tensor:
    """Call the one-op C entry of ``lib`` on checked tensors."""
    _, in_dt, out_dt = OPS[name]
    if a.dtype != in_dt or b.dtype != in_dt or a.shape != b.shape:
        raise ValueError(f"{name} takes two {in_dt} tensors of one shape")
    out = torch.empty(a.shape, dtype=out_dt, device=a.device)
    fn = entry(lib, "probe_i16_op_launch", _OP_ARGTYPES)
    check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             OP_NAMES.index(name), a.numel(), device, stream), f"op {name}")
    return out


def one_op(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One op: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cpu(a, b):
        return op_plain(name, a, b)
    device, stream = require_cuda(a, b)
    out = op_launch(library(), name, a, b, device, stream)
    launches["P2-ops"] += 1
    return out


def op_sass(sass_text: str) -> dict:
    """{op: instructions its kernel has beyond the copy kernel's, by
    opcode}: what the op became."""
    functions = sass_functions(sass_text)

    def hist(name):
        return histogram(find_function(
            functions, "op_kernel", f"ILi{OP_NAMES.index(name)}E"))
    base = hist("copy")
    out = {}
    for name in OP_NAMES:
        h = hist(name)
        out[name] = {op: n - base.get(op, 0) for op, n in h.items()
                     if n != base.get(op, 0)}
    return out


def support_matrix(device=None) -> dict:
    """{op: {"ok": the kernel equals the plain version on the card}} on the
    script's inputs and on one seeded full-range draw."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    rows = {}
    for name in OP_NAMES:
        ok = True
        for seed in (None, 16):
            a, b = op_inputs(name, dev, seed)
            ok = ok and torch.equal(one_op(name, a, b), op_plain(name, a, b))
        rows[name] = {"ok": ok}
    return rows


# ---- (b) the throughput A/B ------------------------------------------------

ARMS = ("i32", "i16", "packed")
N_ARRAYS, N_ITERS, C1 = 8, 4096, 0x1D
# (blocks, elements per block): the TPG kernels' 2560 channels, and every SM
# full
GEOMETRIES = {"tpg": (20, 128), "saturating": (132, 1024)}


def mix_inputs(n: int, device="cpu", seed: int = 0) -> dict:
    """{arm: (8, n) input} of one draw (``rng.integers(-1000, 1000)``,
    :144-145): int32, int16, and int32 words holding elements 2i (low) and
    2i + 1 (high) of the int16 input."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, size=(N_ARRAYS, n))
    a16 = np.ascontiguousarray(a.astype(np.int16))
    return {"i32": torch.from_numpy(a.astype(np.int32)).to(device),
            "i16": torch.from_numpy(a16).to(device),
            "packed": torch.from_numpy(a16.view(np.int32).copy()).to(device)}


def mix_plain(a: torch.Tensor, n_iters: int, arm: str) -> torch.Tensor:
    """The plain PyTorch version of ``_mix_kernel`` (:118-128) for one arm;
    the packed arm runs the int16 chain on the words' halves."""
    if arm == "packed":
        return mix_plain(a.view(I16), n_iters, "i16").view(I32)
    sh = 31 if arm == "i32" else 15
    xs = list(a.clone())
    for _ in range(n_iters):
        prev = xs[-1]
        for j in range(len(xs)):
            m = (xs[j] - prev) >> sh
            xs[j] = ((xs[j] ^ m) & prev) + C1
            prev = xs[j]
    return torch.stack(xs)


def mix_launch(lib, a: torch.Tensor, n_iters: int, arm: str, blocks: int,
               threads: int, device: int = 0, stream=None) -> torch.Tensor:
    """Call the mix's C entry of ``lib`` on checked tensors: ``a`` is (8,
    blocks * threads) of the arm's type."""
    want = I16 if arm == "i16" else I32
    if a.dtype != want or tuple(a.shape) != (N_ARRAYS, blocks * threads):
        raise ValueError(f"the {arm} arm takes ({N_ARRAYS}, "
                         f"{blocks * threads}) {want}, got "
                         f"{tuple(a.shape)} {a.dtype}")
    out = torch.empty_like(a)
    fn = entry(lib, "probe_i16_mix_launch", _MIX_ARGTYPES)
    check(fn(a.data_ptr(), out.data_ptr(), ARMS.index(arm), n_iters, blocks,
             threads, device, stream), f"mix {arm}")
    return out


def mix(a: torch.Tensor, n_iters: int, arm: str, blocks: int) -> torch.Tensor:
    """The mix of one arm over ``blocks`` blocks: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if on_cpu(a):
        return mix_plain(a, n_iters, arm)
    device, stream = require_cuda(a)
    if a.shape[1] % blocks:
        raise ValueError(f"{a.shape[1]} elements do not fill {blocks} blocks")
    out = mix_launch(library(), a, n_iters, arm, blocks,
                     a.shape[1] // blocks, device, stream)
    launches["P2-mix"] += 1
    return out


def mix_sass(sass_text: str) -> dict:
    """{arm: {"alu_per_step", "loop"}}: the loop body's instructions per
    step of one array (5 source ops), and its opcode histogram."""
    functions = sass_functions(sass_text)
    out = {}
    for i, arm in enumerate(ARMS):
        body = loop_body(find_function(functions, "mix_kernel", f"ILi{i}E"))
        out[arm] = {"alu_per_step": alu_count(body) / N_ARRAYS,
                    "loop": histogram(body)}
    return out


def throughput_ab(device=None, trials: int = 3, n_iters: int = N_ITERS,
                  geometries=GEOMETRIES, check_iters: int = 64) -> dict:
    """Per geometry: parity of every arm against its plain version at
    ``check_iters`` steps and of the three arms against each other at the
    full count, then ms per call per arm, the arms visited in rotated
    order, and the int16 / int32 and packed / int32 speedups."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    out = {}
    for gname, (blocks, per_block) in geometries.items():
        feeds = mix_inputs(blocks * per_block, dev)
        for arm in ARMS:
            got = mix(feeds[arm], check_iters, arm, blocks)
            if not torch.equal(got, mix_plain(feeds[arm], check_iters, arm)):
                raise AssertionError(f"mix {arm} ({gname}) differs from its "
                                     "plain version")
        full = {arm: mix(feeds[arm], n_iters, arm, blocks) for arm in ARMS}
        # the packed arm runs the int16 chain; the int32 chain is another
        # function once a value leaves the int16 range
        if not torch.equal(full["i16"].view(I32), full["packed"]):
            raise AssertionError(f"mix packed and i16 arms disagree "
                                 f"({gname})")
        per = {arm: [] for arm in ARMS}
        for t in range(trials):
            for arm in rotated(ARMS, t):
                per[arm].append(event_ms(
                    lambda arm=arm: mix(feeds[arm], n_iters, arm, blocks)))
        ms = {arm: statistics.median(per[arm]) for arm in ARMS}
        out[gname] = {"blocks": blocks, "elements": blocks * per_block,
                      "ms_i32": ms["i32"], "ms_i16": ms["i16"],
                      "ms_packed": ms["packed"],
                      "i16_speedup": ms["i32"] / ms["i16"],
                      "packed_speedup": ms["i32"] / ms["packed"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    args = ap.parse_args(argv)
    info = device_preflight()
    rows = support_matrix()
    sass_text = _build.sass("probes")
    sass = op_sass(sass_text)
    result = {"device": info.get("nvidia_smi"),
              "matrix": {k: v["ok"] for k, v in rows.items()},
              "sass": sass}
    if not args.skip_throughput:
        result["throughput"] = throughput_ab(trials=args.trials)
        result["sass_mix"] = mix_sass(sass_text)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
