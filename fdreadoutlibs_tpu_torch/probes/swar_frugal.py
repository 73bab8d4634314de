"""P3: the frugal pedestal chain, one channel per 32-bit register against
two — counterpart of ``scripts/bench_swar_frugal.py``.

    python -m fdreadoutlibs_tpu_torch.probes.swar_frugal

The frugal-streaming chain (``clip(s - m, -1, 1)``, accumulate, move the
median at +-10) is the piece of the tick that packs best: its deltas are in
{-1, 0, 1}, so with biased halves the packed adds never borrow.  If two
channels per register do not beat one here, they do not for the whole tick.
Arms (``csrc/probes_swar.cu``): ``unpacked``; ``packed`` (the JAX kernel's
int32 shifts and compares per half, :64-86); ``packed_simd`` (``__vcmpgts2``
/ ``__vcmplts2`` / ``__vsub2`` / ``__vadd2``); ``packed_minmax`` (the clip
as ``__vmaxs2(__vmins2(d, 1), -1)``).  One launch walks the whole
window.  Every packed arm is held equal to ``unpacked`` bit for bit after
un-biasing (:157-161), and every arm to its plain version, before anything
is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time

import numpy as np
import torch

from . import (alu_count, check, entry, event_ms, find_function, histogram,
               launches, library, loop_body, max_abs_err, on_cpu,
               require_cuda, rotated, sass_functions)
from ..ops import _build
from ..utils.preflight import device_preflight

LIMIT = 10
BA = 1 << 14           # bias of the value halves
BC = 1 << 7            # bias of the accumulator halves
ARMS = ("unpacked", "packed", "packed_simd", "packed_minmax")
GROUP = 16             # ticks the kernel unrolls (csrc/probes_swar.cu)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def make_adcs(T: int, C: int, seed: int = 0) -> np.ndarray:
    """The script's samples (:110-111): 900 + normal(0, 30), int32."""
    rng = np.random.default_rng(seed)
    return (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)


def pack_pairs(x: torch.Tensor, bias: int) -> torch.Tensor:
    """(..., C) int32 -> (..., C / 2) words: channel 2i biased in the low
    half, 2i + 1 in the high half."""
    return ((x[..., 0::2] + bias) | ((x[..., 1::2] + bias) << 16)) \
        .contiguous()


def unpack_pairs(w: torch.Tensor, bias: int) -> torch.Tensor:
    """The inverse of :func:`pack_pairs` (:157-161)."""
    lo, hi = (w & 0xFFFF) - bias, ((w >> 16) & 0xFFFF) - bias
    return torch.stack([lo, hi], dim=-1).reshape(*w.shape[:-1], -1)


def unpacked_plain(adc: torch.Tensor, m: torch.Tensor, acc: torch.Tensor):
    """The plain PyTorch version of ``_unpacked_kernel`` (:39-48) over all
    ticks of ``adc`` (T, C).  Returns (m, acc)."""
    for s in adc:
        acc = acc + torch.clamp(s - m, -1, 1)
        over, under = acc > LIMIT, acc < -LIMIT
        m = torch.where(over, m + 1, torch.where(under, m - 1, m))
        acc = torch.where(over | under, 0, acc)
    return m, acc


def packed_plain(adc: torch.Tensor, m: torch.Tensor, acc: torch.Tensor):
    """The plain PyTorch version of ``_packed_kernel`` (:64-86): the same
    int32 shifts and compares per half, on packed words (T, C / 2)."""
    i32 = torch.int32
    for s in adc:
        s_lo, m_lo = s << 16, m << 16
        s_hi, m_hi = s >> 16, m >> 16
        delta = ((s_lo > m_lo).to(i32) - (s_lo < m_lo).to(i32)) + \
            (((s_hi > m_hi).to(i32) - (s_hi < m_hi).to(i32)) << 16)
        acc = acc + delta
        a_lo, a_hi = acc << 16, acc >> 16
        ov_lo = (a_lo > ((LIMIT + BC) << 16)).to(i32)
        un_lo = (a_lo < ((-LIMIT + BC) << 16)).to(i32)
        ov_hi = (a_hi > (LIMIT + BC)).to(i32)
        un_hi = (a_hi < (-LIMIT + BC)).to(i32)
        m = m + (ov_lo - un_lo) + ((ov_hi - un_hi) << 16)
        acc = torch.where((ov_lo | un_lo) != 0, (acc & ~0xFFFF) | BC, acc)
        acc = torch.where((ov_hi | un_hi) != 0, (acc & 0xFFFF) | (BC << 16),
                          acc)
    return m, acc


def frugal_launch(lib, adc: torch.Tensor, m: torch.Tensor, acc: torch.Tensor,
                  arm: str, device: int = 0, stream=None):
    """Call the C entry of ``lib`` on checked tensors; returns fresh (m,
    acc)."""
    n = m.shape[0]
    if not (adc.dtype == m.dtype == acc.dtype == torch.int32) or \
            adc.dim() != 2 or adc.shape[1] < n or acc.shape != m.shape:
        raise ValueError(f"expected (T, >= {n}) int32 samples and ({n},) "
                         f"int32 m and acc, got {tuple(adc.shape)}, "
                         f"{tuple(m.shape)}, {tuple(acc.shape)}")
    m, acc = m.clone(), acc.clone()
    fn = entry(lib, "probe_swar_launch", _ARGTYPES)
    check(fn(adc.data_ptr(), adc.shape[1], adc.shape[0], m.data_ptr(),
             acc.data_ptr(), n, ARMS.index(arm), device, stream),
          f"frugal {arm}")
    return m, acc


def frugal(adc: torch.Tensor, m: torch.Tensor, acc: torch.Tensor,
           arm: str = "unpacked"):
    """The frugal chain of one arm over a window: (T, C) samples with (C,)
    state for ``unpacked``, (T, C / 2) packed words and state for the
    packed arms.  The kernel on CUDA tensors, the plain version on CPU
    tensors (the packed arms share one)."""
    if on_cpu(adc, m, acc):
        return (unpacked_plain if arm == "unpacked" else packed_plain)(
            adc, m, acc)
    device, stream = require_cuda(adc, m, acc)
    out = frugal_launch(library(), adc, m, acc, arm, device, stream)
    launches["P3-unpacked" if arm == "unpacked" else "P3-packed"] += 1
    return out


def arm_inputs(adcs: np.ndarray, device) -> dict:
    """{arm: (feed, m0, acc0)} on ``device`` from (T, C) samples: medians
    start at 900, accumulators at 0 (:118-122)."""
    x = torch.from_numpy(adcs).to(device)
    C = x.shape[1]
    m0 = torch.full((C,), 900, dtype=torch.int32, device=device)
    a0 = torch.zeros((C,), dtype=torch.int32, device=device)
    packed = (pack_pairs(x, BA), pack_pairs(m0, BA), pack_pairs(a0, BC))
    return {arm: (x, m0, a0) if arm == "unpacked" else packed
            for arm in ARMS}


def check_parity(inputs: dict) -> dict:
    """Run every arm once and hold it to its plain version (``unpacked`` to
    :func:`unpacked_plain`, every packed arm to :func:`packed_plain`, whose
    words they share), and every packed arm un-biased to ``unpacked``.
    Raises on a mismatch.  Returns {arm: {"max_abs_err", "plain_ms"}}: the
    error measured against the plain version and its host-clocked ms."""
    res = {arm: frugal(*inputs[arm], arm) for arm in ARMS}
    want, plain_ms = {}, {}
    for arm, fn in (("unpacked", unpacked_plain), ("packed", packed_plain)):
        t0 = time.perf_counter()
        want[arm] = fn(*inputs[arm])
        if inputs[arm][0].is_cuda:
            torch.cuda.synchronize()
        plain_ms[arm] = (time.perf_counter() - t0) * 1e3
    out = {}
    for arm in ARMS:
        of = "unpacked" if arm == "unpacked" else "packed"
        err = max_abs_err(res[arm], want[of])
        if err != 0:
            raise AssertionError(f"{arm} differs from its plain version "
                                 f"(max abs err {err})")
        out[arm] = {"max_abs_err": err, "plain_ms": plain_ms[of]}
    mu, au = res["unpacked"]
    for arm in ARMS[1:]:
        mp, ap = res[arm]
        if not (torch.equal(unpack_pairs(mp, BA), mu)
                and torch.equal(unpack_pairs(ap, BC), au)):
            raise AssertionError(f"{arm} differs from unpacked after "
                                 "un-biasing")
    return out


def frugal_sass(sass_text: str) -> dict:
    """{arm: {"alu_per_tick", "loop"}}: the unrolled loop body's arithmetic
    instructions per tick (per thread: one channel, or a pair), and its
    opcode histogram."""
    functions = sass_functions(sass_text)
    out = {}
    for i, arm in enumerate(ARMS):
        body = loop_body(find_function(functions, "frugal_kernel",
                                       f"ILi{i}E"))
        out[arm] = {"alu_per_tick": alu_count(body) / GROUP,
                    "loop": histogram(body)}
    return out


def run(device=None, C: int = 2560, T: int = 8192, trials: int = 4,
        reps: int = 16) -> dict:
    """Parity, then ms per window per arm (means of ``reps`` launches by
    CUDA events, medians over ``trials``, arms in rotated order) with
    giga-samples per second, threads, and the packed arms' speedups."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    inputs = arm_inputs(make_adcs(T, C), dev)
    checked = check_parity(inputs)
    per = {arm: [] for arm in ARMS}
    for t in range(trials):
        for arm in rotated(ARMS, t):
            per[arm].append(event_ms(
                lambda arm=arm: frugal(*inputs[arm], arm), reps))
    res = {}
    for arm in ARMS:
        ms = statistics.median(per[arm])
        res[arm] = {"ms": ms, "gsps": T * C / (ms * 1e-3) / 1e9,
                    "threads": inputs[arm][1].shape[0], **checked[arm]}
    res["swar_speedup"] = res["unpacked"]["ms"] / res["packed"]["ms"]
    res["swar_speedup_simd"] = res["unpacked"]["ms"] / \
        res["packed_simd"]["ms"]
    res["swar_speedup_minmax"] = res["unpacked"]["ms"] / \
        res["packed_minmax"]["ms"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--reps", type=int, default=16,
                    help="launches per timed call")
    args = ap.parse_args(argv)
    info = device_preflight()
    res = run(None, args.channels, args.ticks, args.trials, args.reps)
    res["device"] = info.get("nvidia_smi")
    res["sass"] = frugal_sass(_build.sass("probes"))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
