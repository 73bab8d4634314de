"""Random-configuration semantic fuzz — counterpart of ``scripts/fuzz_sweep.py``.

Each case draws the configuration space as ``tests/test_fuzz_semantics.py::
_case`` does (:23-46, copied in :func:`case`): the family, thresholds,
accumulator limits of 5-20, scale factors, memory factors of 0-10 per
channel, peak tracking, and uneven batch boundaries in a 192 x 40 stream
with pulses of up to 4000 on a noise of 3-30 around 900, clipped to 14
bits.  Its batches go, state carried, through

* the port's scan (``ops/scan.py``), held to the numpy oracle
  (``ops/reference.run_reference``): hits and every state field;
* the kernel's plain version (``tpg.process_window`` on CPU tensors, plain
  samples, one chunk a batch, a slot for every close a batch can hold),
  held to the oracle: hits, no drop, state;
* on a card, the CUDA kernel on the same inputs: slots, nclose and state
  equal to the plain version, bit for bit: K2 for the threshold families
  and K3 (on the plain datapath) for FIR.

Every ``kernel_every``'th case also runs the time2 feed (K1; K3 on time2
rows for FIR) on the same stream cut at even ticks and, for FIR, the
two-pass schedule with lifted emission (``fir_twopass`` 2, K5), each
through the plain version and the kernel, held to the oracle and to each
other the same way.

``python -m fdreadoutlibs_tpu_torch.probes.fuzz_sweep --n 200 --start
20000`` on the card (one JSON line per failure, then a summary; exit 1 on
any mismatch); ``--device cpu`` runs the plain version in the kernel's
place.  Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import Algorithm, TPGConfig, tpg
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.hits import concat_hits, decode_dense
from ..ops.ingest import decode_slots
from ..ops.reference import run_reference
from ..ops.scan import process_window_scan, state_to_numpy, state_to_torch

T, C = 192, 40


def case(seed: int):
    """(cfg, memory factors, adcs (T, C), batch bounds) of one seed: the
    copy of ``tests/test_fuzz_semantics.py::_case`` (:23-46)."""
    rng = np.random.default_rng(seed)
    alg = Algorithm(rng.choice(["SimpleThreshold", "AbsRS", "StandardRS",
                                "FIR"]))
    fir = alg == Algorithm.FIR
    cfg = TPGConfig(
        algorithm=alg,
        threshold=int(rng.integers(3, 9)) if fir
        else int(rng.integers(80, 301)),
        accumulator_limit=int(rng.choice([5, 10, 20])),
        rs_scale_factor_x10=int(rng.choice([5, 10, 20])),
        track_peaks=bool(rng.integers(0, 2)) if fir else True,
    )
    rmf = rng.choice([0, 2, 8, 10], size=C).astype(np.int32)
    noise = int(rng.integers(3, 31))
    adcs = (900 + rng.normal(0, noise, size=(T, C))).astype(np.int32)
    for _ in range(30):
        c, t = rng.integers(0, C), rng.integers(1, T - 12)
        adcs[t:t + rng.integers(2, 10), c] += rng.integers(150, 4000)
    adcs = np.clip(adcs, 0, (1 << 14) - 1)
    # uneven batch boundaries (2-4 splits at arbitrary ticks)
    cuts = np.sort(rng.choice(np.arange(8, T - 8), size=rng.integers(2, 5),
                              replace=False))
    return cfg, rmf, adcs, [0, *cuts.tolist(), T]


def scan_run(cfg, rmf, adcs, bounds) -> tuple:
    """The port's scan over the batches: (hits, state numpy dict)."""
    state = state_to_torch(seed_chanstate(init_chanstate(C), adcs[0], rmf))
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        closed, records, state = process_window_scan(
            torch.from_numpy(adcs[a:b]), state, cfg)
        parts.append(decode_dense(closed, records, tick_offset=a))
    return concat_hits(parts), state_to_numpy(state)


def even_bounds(bounds) -> list:
    """The batch bounds moved down to even ticks (time2 words hold two),
    repeats dropped."""
    out = []
    for b in bounds:
        b -= b % 2
        if not out or b > out[-1]:
            out.append(b)
    return out


def kernel_run(cfg, rmf, adcs, bounds, device, time2: bool = False,
               fir_twopass: int = 0) -> tuple:
    """The batches through ``tpg.process_window`` on ``device`` (a chunk a
    batch, every close kept) and through its plain version on the CPU:
    (hits, dropped, state numpy dict, launches).  Raises when the
    device's slots, nclose or state differ from the plain version's."""
    st0 = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C)
    on_card = torch.device(device).type != "cpu"
    where = {"cpu": "cpu", **({"dev": device} if on_card else {})}
    states = {w: st0.to(dev) for w, dev in where.items()}
    parts, dropped, launches = [], 0, 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        win = adcs[a:b]
        feed = torch.from_numpy(np.ascontiguousarray(
            (win[0::2] & 0xFFFF) | (win[1::2] << 16) if time2 else win))
        n = b - a
        outs = {}
        for w, dev in where.items():
            outs[w] = tpg.process_window(
                feed.to(dev), states[w], cfg, n, n // 2 + 1,
                time_packed=time2, fir_twopass=fir_twopass)
            states[w] = outs[w][2]
        if on_card:
            launches += 1
            for what, g, w in zip(("slots", "nclose", "state"), outs["dev"],
                                  outs["cpu"]):
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(
                        f"kernel {what} differ from the plain version in "
                        f"ticks {a}-{b} (time2={time2}, "
                        f"fir_twopass={fir_twopass})")
        h, d = decode_slots(outs["cpu"][0], outs["cpu"][1], C,
                            tick_offset=a)
        parts.append(h)
        dropped += d
    return concat_hits(parts), dropped, tpg.unpack_state(states["cpu"]), \
        launches


def _same_state(label: str, got: dict, want) -> None:
    for k, v in want.items():
        if k in ("fir_prev", "fir_phase") or k not in got:
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=f"{label} state[{k}]")


def run_case(seed: int, device, kernel: bool) -> dict:
    """One seed through the scan, the plain version and the device (and,
    with ``kernel``, the time2 feed and for FIR the lifted two-pass
    schedule).  Returns {"seed", "alg", "runs", "launches"}; raises on a
    mismatch."""
    cfg, rmf, adcs, bounds = case(seed)
    h_ref, st_ref = run_reference(adcs, cfg, rs_memory_factor=rmf)
    h_scan, st_scan = scan_run(cfg, rmf, adcs, bounds)
    np.testing.assert_array_equal(h_scan, h_ref, err_msg="scan hits")
    _same_state("scan", st_scan, st_ref)
    runs = [(bounds, False, 0)]
    if kernel:
        runs.append((even_bounds(bounds), True, 0))
        if cfg.algorithm == Algorithm.FIR:
            runs.append((bounds, False, 2))
    launches = 0
    for b, time2, tp in runs:
        label = f"time2={time2} fir_twopass={tp}"
        h, d, st, n = kernel_run(cfg, rmf, adcs, b, device, time2, tp)
        if d:
            raise AssertionError(f"{label}: {d} closes dropped")
        np.testing.assert_array_equal(h, h_ref, err_msg=f"{label} hits")
        _same_state(label, st, st_ref)
        launches += n
    return {"seed": seed, "alg": cfg.algorithm.value, "runs": len(runs),
            "launches": launches}


def sweep(n: int, start: int, device=None, kernel_every: int = 5,
          log=print) -> dict:
    """``n`` seeds from ``start``; a failing seed is reported (one JSON
    line) and counted.  Returns the summary."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fuzz_sweep needs a CUDA card (device='cpu' "
                               "runs the plain version in its place)")
        device = "cuda:0"
    t0 = time.perf_counter()
    failures = kernel_cases = launches = 0
    by_alg: dict[str, int] = {}
    for i in range(n):
        seed = start + i
        kernel = bool(kernel_every) and i % kernel_every == 0
        try:
            res = run_case(seed, device, kernel)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures += 1
            log(json.dumps({"seed": seed, "error": str(e)[:400]}))
            continue
        by_alg[res["alg"]] = by_alg.get(res["alg"], 0) + 1
        kernel_cases += kernel
        launches += res["launches"]
    return {"swept": n, "start": start, "failures": failures,
            "kernel_cases": kernel_cases, "launches": launches,
            "by_alg": by_alg, "device": str(device),
            "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=20_000,
                    help="first seed (the test suite owns 101..1010)")
    ap.add_argument("--kernel-every", type=int, default=5,
                    help="add the time2 feed and FIR's two-pass schedule "
                    "on every k-th case (0 = never)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain version in the kernel's "
                    "place")
    args = ap.parse_args(argv)
    res = sweep(args.n, args.start, args.device, args.kernel_every)
    print(json.dumps(res))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
