"""P1: the int32 issue rate and dependent-op latency of the card, and the
TPG kernels against that ceiling — counterpart of ``scripts/roofline.py``.

    python -m fdreadoutlibs_tpu_torch.probes.roofline

The kernel (``csrc/probes_issue.cu``) runs ``ilp`` independent chains of
dependent int32 ops (``x += 0x9E3779B9; x ^= x >> 7``) per thread, 96 ops per
thread per iteration; :func:`probe_issue_rate` times it by CUDA events at two
iteration counts and takes the slope, so launch overhead cancels
(``roofline.py`` :189-206).  Where the TPU script sweeps the tile's rows,
:data:`ARMS` sweeps what hides latency on a GPU: chains per thread, warps
per SM and blocks — from the TPG kernels' own geometry (20 blocks of 128
threads, one chain) to all 132 SMs full of warps.  Each arm gives ops per
second, ops per clock per SM against the nominal 64 int32 lanes, and SM
cycles per dependent op at the measured clock.  The compiler may fuse or
re-shape the three source ops, so :func:`loop_sass` reads the loop body's
machine code and every rate stands beside its instruction count per step.

:func:`main` then does what the script's does: per family, the kernel's
time at T=8192 x 2560 turned into ops per second through one per-tick op
count (:data:`OPS_PER_TICK`, counted from ``csrc/tpg.cuh``), as a share of
the measured ceiling, and the cycles one thread spends per tick beside the
probe's cycles per dependent op at that geometry.  The TPU script counts
tile issues from a jaxpr; a tile has no meaning here and that part is not
carried over.
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
from ..utils.preflight import device_preflight, sm_clock_mhz

GOLDEN = int(np.int32(np.uint32(0x9E3779B9)))
UNITS = 32                      # steps per iteration over all chains
OPS_PER_STEP = 3                # add, shift, xor
ITERS = (20_000, 120_000)
CHECK_ITERS = 16                # iterations of an arm's check against plain
SMS, INT32_LANES = 132, 64      # H100 SXM: int32 lanes per SM per clock
TPG_GEOMETRY = (20, 128)        # 2560 channels: csrc/tpg.cuh::kBlock

# Operations per tick per channel of the function each family computes,
# counted from csrc/tpg.cuh (ThresholdChannel::tick, FirChannel::tick), and
# of the feed decode per tick (time2: one shift or wrap; packed: the funnel
# shift and mask).
OPS_PER_TICK = {"SimpleThreshold": 26, "AbsRS": 42, "StandardRS": 40,
                "FIR": 68}
DECODE_OPS = {"plain": 0, "time2": 1, "packed14": 2}

# (name, ilp, blocks, threads): the TPG kernels' geometry against ILP; one
# block per SM; then SMs full of warps, where more warps must not help
ARMS = (("tpg_ilp1", 1, 20, 128), ("tpg_ilp2", 2, 20, 128),
        ("tpg_ilp4", 4, 20, 128), ("tpg_ilp8", 8, 20, 128),
        ("tpg_ilp16", 16, 20, 128),
        ("sm132_w4_ilp1", 1, 132, 128), ("sm132_w4_ilp4", 4, 132, 128),
        ("sm132_w32_ilp1", 1, 132, 1024), ("sm132_w32_ilp4", 4, 132, 1024),
        ("sm132_w64_ilp4", 4, 264, 1024))

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]


def issue_plain(x: torch.Tensor, n_iters: int,
                units: int = UNITS) -> torch.Tensor:
    """The plain PyTorch version: (ilp, n) int32 chains, ``n_iters``
    iterations of ``units // ilp`` steps each (``roofline.py`` :167-175).
    Every chain runs the same steps, so the chains advance together."""
    per_chain = max(1, units // x.shape[0])
    x = x.clone()
    for _ in range(n_iters * per_chain):
        x = x + GOLDEN
        x = x ^ (x >> 7)
    return x


def issue_launch(lib, x: torch.Tensor, n_iters: int, blocks: int,
                 threads: int, device: int = 0, stream=None) -> torch.Tensor:
    """Call the C entry of ``lib`` on checked tensors (the CUDA library, or
    the host build of the same source in the CPU tests)."""
    if x.dtype != torch.int32 or x.dim() != 2 or \
            x.shape[1] != blocks * threads:
        raise ValueError(f"expected (ilp, {blocks * threads}) int32 chains, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] not in (1, 2, 4, 8, 16):
        raise ValueError(f"ilp={x.shape[0]}: the kernel is built for 1, 2, "
                         "4, 8 and 16 chains")
    out = torch.empty_like(x)
    fn = entry(lib, "probe_issue_launch", _ARGTYPES)
    check(fn(x.data_ptr(), out.data_ptr(), x.shape[0], n_iters, blocks,
             threads, device, stream), "issue probe")
    return out


def issue_chains(x: torch.Tensor, n_iters: int, blocks: int,
                 threads: int) -> torch.Tensor:
    """Run the chains: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cpu(x):
        return issue_plain(x, n_iters)
    device, stream = require_cuda(x)
    out = issue_launch(library(), x, n_iters, blocks, threads, device, stream)
    launches["P1"] += 1
    return out


def chains_input(ilp: int, n: int, device) -> torch.Tensor:
    """``roofline.py`` :187: arange over the chains."""
    return torch.arange(ilp * n, dtype=torch.int32).reshape(ilp, n).to(device)


def probe_issue_rate(x: torch.Tensor, blocks: int, threads: int,
                     iters=ITERS) -> tuple:
    """One timed trial of one arm on the card: (seconds per iteration, ms at
    iters[1]).  The slope between the two iteration counts cancels the
    launch (``roofline.py`` :189-206)."""
    lo, hi = (event_ms(lambda n=n: issue_chains(x, n, blocks, threads))
              for n in iters)
    return (hi - lo) * 1e-3 / (iters[1] - iters[0]), hi


def loop_sass(sass_text: str) -> dict:
    """{ilp: {"alu_per_step", "loop": opcode histogram of the loop body}}
    of the issue kernels: what one source step (3 ops) became."""
    functions = sass_functions(sass_text)
    out = {}
    for ilp in (1, 2, 4, 8, 16):
        body = loop_body(find_function(functions, "issue_kernel",
                                       f"ILi{ilp}E"))
        out[ilp] = {"alu_per_step": alu_count(body) / UNITS,
                    "loop": histogram(body)}
    return out


def check_arm(x: torch.Tensor, blocks: int, threads: int,
              n_iters: int = CHECK_ITERS) -> dict:
    """One arm's own kernel (its ilp, blocks and threads) against the plain
    version at a small iteration count.  Raises on a mismatch; returns the
    measured error and the plain version's host-clocked ms."""
    got = issue_chains(x, n_iters, blocks, threads)
    t0 = time.perf_counter()
    want = issue_plain(x, n_iters)
    if x.is_cuda:
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(
            f"issue probe, ilp {x.shape[0]} at {blocks} x {threads}: the "
            f"kernel differs from its plain version (max abs err {err})")
    return {"check_iters": n_iters, "max_abs_err": err, "plain_ms": plain_ms}


def probe_arms(device=None, arms=ARMS, iters=ITERS, trials: int = 3) -> dict:
    """Every arm, held to the plain version at its own geometry
    (:func:`check_arm`) before anything is timed, warmed once, then timed
    with the order of visit rotated between trials, and the SM clock read
    right after.  Returns {"sm_mhz", "arms": {name: {...}}}: per arm ops per
    second, ops per clock per SM it occupies (nominal 64), SM cycles per
    dependent op (one chain of one thread), ms at iters[1] (medians over
    the trials), and the check's error and plain ms."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    xs = {name: chains_input(ilp, blocks * threads, dev)
          for name, ilp, blocks, threads in arms}
    checks = {name: check_arm(xs[name], blocks, threads)
              for name, _, blocks, threads in arms}
    for name, _, blocks, threads in arms:
        for n in iters:
            issue_chains(xs[name], n, blocks, threads)
    per = {name: [] for name in xs}
    for t in range(trials):
        for name, _, blocks, threads in rotated(arms, t):
            per[name].append(probe_issue_rate(xs[name], blocks, threads,
                                              iters))
    mhz = sm_clock_mhz()
    out = {}
    for name, ilp, blocks, threads in arms:
        slope = statistics.median(s for s, _ in per[name])
        if slope <= 0:
            raise RuntimeError(f"issue probe {name}: the slope is not "
                               f"positive ({per[name]})")
        ops_per_s = OPS_PER_STEP * UNITS * blocks * threads / slope
        # one thread's chain advances OPS_PER_STEP * UNITS / ilp dependent
        # ops per iteration
        out[name] = {"ilp": ilp, "blocks": blocks, "threads": threads,
                     "gops": ops_per_s / 1e9,
                     "ops_per_clk_per_sm":
                         ops_per_s / (mhz * 1e6) / min(blocks, SMS),
                     "cycles_per_dep_op":
                         slope * mhz * 1e6 / (OPS_PER_STEP * UNITS / ilp),
                     "ms": statistics.median(ms for _, ms in per[name]),
                     **checks[name]}
    return {"sm_mhz": mhz, "arms": out}


def ceiling_gops(probes: dict) -> float:
    """The card's measured int32 rate: the fastest arm of
    :func:`probe_arms`, in 1e9 ops per second."""
    return max(a["gops"] for a in probes["arms"].values())


def bound_ms(ops: float, sm_mhz: float, measured_gops: float) -> float:
    """The least ms the card could take for ``ops`` int32 operations: over
    the larger of the nominal rate (132 SMs x 64 lanes x the clock) and the
    rate the issue probe sustained in the same run (:func:`ceiling_gops`).
    The add runs beside the shift and logic ops, so the card does more
    than 64 a clock on such a mix, and a bound from the nominal lanes alone
    would be no floor."""
    rate = max(SMS * INT32_LANES * sm_mhz * 1e6, measured_gops * 1e9)
    return ops / rate * 1e3


def summarize(probes: dict, kernel_ms: dict, T: int, C: int) -> dict:
    """Each TPG kernel against the probes.  ``kernel_ms`` maps a label to
    (family, decode, ms) of one launch over T ticks x C channels.  Gives
    the kernel's ops per second through :data:`OPS_PER_TICK`, its share of
    the measured ceiling (the fastest arm), the cycles one thread spends
    per tick, and the dependent ops that time would hold at the probe's
    latency in the kernels' geometry (``tpg_ilp1``)."""
    ceiling = ceiling_gops(probes)
    dep = probes["arms"]["tpg_ilp1"]["cycles_per_dep_op"]
    out = {}
    for label, (family, decode, ms) in kernel_ms.items():
        ops = OPS_PER_TICK[family] + DECODE_OPS[decode]
        gops = T * C * ops / (ms * 1e-3) / 1e9
        cycles = ms * 1e-3 * probes["sm_mhz"] * 1e6 / T
        out[label] = {"ms": ms, "ops_per_tick": ops, "gops": gops,
                      "pct_of_ceiling": 100 * gops / ceiling,
                      "cycles_per_tick_per_thread": cycles,
                      "cycles_per_op": cycles / ops,
                      "dep_ops_per_tick_at_probe_latency": cycles / dep}
    return {"ceiling_gops": ceiling, "tpg_cycles_per_dep_op": dep,
            "kernels": out}


def measure_family(cfg, device, C: int = 2560, T: int = 8192,
                   n: int = 20) -> float:
    """ms per launch of the family's kernel on the plain datapath at the
    tuned tc, k and geometry (``roofline.py::measure_family``'s data: 900 +
    normal(0, 30) and 100 pulses)."""
    from ..ops import init_chanstate, seed_chanstate, tpg
    from ..utils.tuning import kernel_knobs
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(100):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    knobs = kernel_knobs(cfg)
    state = tpg.pack_state(seed_chanstate(
        init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10), C,
        device=device)
    feed = torch.from_numpy(adcs).to(device)

    def run():
        return tpg.process_window(feed, state, cfg, knobs["tc"],
                                  knobs["k_slots"], time_packed=False,
                                  fir_twopass=knobs["fir_twopass"],
                                  geometry=knobs["geometry"])
    run()
    return event_ms(run, n)


def main(argv=None) -> int:
    from ..ops import TPGConfig
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    info = device_preflight()
    dev = torch.device("cuda", 0)
    out = {"device": info.get("nvidia_smi"), "channels": args.channels,
           "ops_per_tick": OPS_PER_TICK}
    probes = probe_arms(dev, trials=args.trials)
    sass = loop_sass(_build.sass("probes"))
    for a in probes["arms"].values():
        a["sass_alu_per_step"] = sass[a["ilp"]]["alu_per_step"]
    out["sm_mhz"] = probes["sm_mhz"]
    out["probe_issue_gops"] = {k: round(a["gops"], 2)
                               for k, a in probes["arms"].items()}
    out["probes"] = probes["arms"]
    out["sass_loop"] = {str(k): v["loop"] for k, v in sass.items()}
    families = {
        "SimpleThreshold": TPGConfig.from_raw("SimpleThreshold",
                                              threshold=150),
        "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
        "StandardRS": TPGConfig.from_raw("StandardRS", threshold=150),
        "FIR": TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)}
    kernel_ms = {name: (name, "plain", measure_family(
        cfg, dev, args.channels, args.ticks)) for name, cfg in
        families.items()}
    summary = summarize(probes, kernel_ms, args.ticks, args.channels)
    out["ceiling_gops"] = summary["ceiling_gops"]
    out["measured"] = summary["kernels"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
