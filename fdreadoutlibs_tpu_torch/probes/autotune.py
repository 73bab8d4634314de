"""The knob tuner on the card — counterpart of ``scripts/autotune.py``.

It sweeps the launch knobs of each algorithm family on the attached card
and writes a tuned file that ``utils/tuning.py::kernel_knobs`` reads (the
JAX package reads the same file and ignores the card's geometry keys).

* *What it measures* — the JAX tuner's measurement on its data (:79-89):
  seed 0, ``900 + normal(0, 30)`` with 200 pulses, 2560 channels x 8192
  ticks, a chain of ``windows`` launches carrying state, on the time2 feed.
  AbsRS, StandardRS and SimpleThreshold at threshold 150 run K1; FIR at
  threshold 5 without peaks runs K3, or K5 under ``twopass`` 1 and 2.
* *Timing* — CUDA events around each chain after an L2 flush (in place of
  the tunnel's slope), the candidates visited in an order that rotates
  every trial, medians over trials.
* *The space* — ``tc`` in {256, 512, 1024} and ``k`` in {1, 2, 4}, FIR also
  ``twopass`` in {0, 1, 2}, at each geometry of :func:`geometry_space`: the
  shipped one and one knob at a time away from it (``group`` 8 / 32,
  ``stage_ticks`` 16 / 64, ``stages`` 2 / 8), a kernel library each.
  ``--quick`` keeps tc {256, 512}, k {1, 2} and one geometry besides the
  shipped one; it still holds every shipped point.
* *Checks* — a candidate that breaks a rule of ``utils/tuning.py`` is
  skipped before any build, with the reason in the log; an ``nvcc``
  failure or a launch error raises.  With ``check=True`` (the default on a
  card) each candidate's first window must equal the plain version at its
  tc and k (slots, nclose and state), and every geometry the shipped one's
  outputs, bit for bit.
* *The decision* — ``--confirm N`` re-measures the sweep's N best and the
  shipped knobs in two independent rotated passes and keeps a challenger
  only if it beat the shipped knobs by more than 2% in both
  (:func:`confirm_stage`, ``_confirm_stage`` :156-213, the case of a
  shipped arm that does not measure included).

``python -m fdreadoutlibs_tpu_torch.probes.autotune --quick --confirm 2
--out tuned.json`` on the card; ``--device cpu`` runs the plain versions
(times mean nothing there; for the tests).  Without a card and without
``--device cpu`` it raises, as the JAX tuner asserts a TPU (:235).
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import sys
import time

import numpy as np
import torch

from ..ops import _build, tpg
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.config import Algorithm, TPGConfig
from ..utils.tuning import (KNOBS, SHIPPED_GEOMETRY, Geometry,
                            geometry_problem)

ALGS = ["SimpleThreshold", "AbsRS", "StandardRS", "FIR"]
KNOB_KEYS = ("tc", "k", "twopass", "group", "stage_ticks", "stages")
# the one geometry besides the shipped one that --quick sweeps
QUICK_GEOMETRY = Geometry(16, 64, 4)
# an L2 flush: larger than the H100's 50 MB L2
_FLUSH_BYTES = 128 << 20
# the full-capacity plain run's chunk: divides every tc of the space
_PLAIN_TC = 256


def family_cfg(alg: str) -> TPGConfig:
    """The tuner's configuration of a family (:83-84): FIR at threshold 5
    without peak tracking, the others at threshold 150."""
    kw = {"track_peaks": False} if alg == "FIR" else {}
    return TPGConfig.from_raw(alg, threshold=5 if alg == "FIR" else 150,
                              **kw)


def shipped_knobs(alg: str) -> dict:
    """The shipped point of a family in the tuner's keys."""
    ship = KNOBS[Algorithm(alg)]
    out = {"tc": ship["tc"], "k": ship["k"]}
    if "fir_twopass" in ship:
        out["twopass"] = ship["fir_twopass"]
    return out | SHIPPED_GEOMETRY._asdict()


def geometry_space(quick: bool, geometries=None) -> list:
    """The shipped geometry, then one knob at a time away from it (quick:
    :data:`QUICK_GEOMETRY` alone), or the ``geometries`` given (the
    shipped one always first)."""
    ship = SHIPPED_GEOMETRY
    if geometries is None:
        geometries = [QUICK_GEOMETRY] if quick else [
            ship._replace(group=8), ship._replace(group=32),
            ship._replace(stage_ticks=16), ship._replace(stage_ticks=64),
            ship._replace(stages=2), ship._replace(stages=8)]
    out = [ship]
    for g in map(lambda g: Geometry(*g), geometries):
        if g not in out:
            out.append(g)
    return out


def candidate_space(quick: bool, geometries=None) -> list:
    """Every (tc, k) at every geometry (``candidate_space`` :43-56 with the
    card's geometry in place of sub and unroll)."""
    tcs = [256, 512] if quick else [256, 512, 1024]
    ks = [1, 2] if quick else [1, 2, 4]
    return [{"tc": tc, "k": k, **g._asdict()} for g, tc, k in
            itertools.product(geometry_space(quick, geometries), tcs, ks)]


def fir_space(quick: bool, geometries=None) -> list:
    """FIR adds the schedule: 0 the fused tick, 1 two-pass, 2 two-pass with
    lifted emission (``fir_space`` :59-63)."""
    return [c | {"twopass": tp} for c in candidate_space(quick, geometries)
            for tp in (0, 1, 2)]


def space(alg: str, quick: bool, geometries=None) -> list:
    return fir_space(quick, geometries) if alg == "FIR" \
        else candidate_space(quick, geometries)


def make_adcs(C: int, T: int) -> np.ndarray:
    """The JAX tuner's samples (:85-89)."""
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(200):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    return adcs


def geometry_of(cand: dict) -> Geometry:
    return Geometry(*(cand.get(f, d) for f, d in
                      zip(Geometry._fields, SHIPPED_GEOMETRY)))


def skip_reason(alg: str, cand: dict, T: int):
    """Why a candidate cannot run, found before any build: a tc that does
    not divide the window or is odd (the time2 feed), or a geometry that
    breaks a rule of ``utils/tuning.py`` for the family on time2 rows."""
    tc = cand["tc"]
    if T % tc or tc % 2:
        return f"tc={tc} does not divide {T} ticks in even chunks"
    return geometry_problem(geometry_of(cand), Algorithm(alg), "time2",
                            False, cand.get("twopass", 0))


def reslot(slots, nclose, tc_from: int, tc: int, k: int) -> tuple:
    """(slots, nclose) of a run at chunk tc_from that kept every close,
    re-chunked to tc (a multiple of tc_from) with k slots: the outputs of
    the same run at (tc, k).  A chunk's closes keep their order, and its
    slots hold the first k."""
    n_from, K, nw, C = slots.shape
    if int(nclose.max()) > K:
        raise ValueError("the full-capacity run dropped closes")
    m = tc // tc_from
    n = n_from // m
    src = slots.reshape(n, m * K, nw, C)
    idx = torch.arange(K, device=slots.device).repeat(m)
    counts = nclose.reshape(n, m, C).repeat_interleave(K, dim=1)
    valid = idx[None, :, None] < counts
    rank = valid.to(torch.int32).cumsum(1) - 1
    target = torch.where(valid & (rank < k), rank, k).to(torch.int64)
    out = torch.zeros((n, k + 1, nw, C), dtype=slots.dtype,
                      device=slots.device)
    out.scatter_(1, target[:, :, None, :].expand(n, m * K, nw, C), src)
    return out[:, :k].contiguous(), \
        nclose.reshape(n, m, C).sum(1, dtype=torch.int32)


class Family:
    """One family's inputs on a device: the time2 feed of the first window,
    the seeded state, and its plain outputs at full capacity."""

    def __init__(self, alg: str, C: int, T: int, device):
        self.alg = alg
        self.cfg = family_cfg(alg)
        self.T, self.C = T, C
        adcs = make_adcs(C, T)
        st = seed_chanstate(init_chanstate(C), adcs[0],
                            self.cfg.rs_memory_factor_x10)
        self.state = tpg.pack_state(st, C, device=device)
        words = (adcs[0::2] & 0xFFFF) | (adcs[1::2] << 16)
        self.feed = torch.from_numpy(np.ascontiguousarray(words)).to(device)
        self._plain = None

    def plain(self) -> tuple:
        """The plain version's first window at chunk 256 with a slot for
        every close a chunk can hold (a close takes two ticks)."""
        if self._plain is None:
            self._plain = tpg.process_window_plain(
                self.feed, self.state, self.cfg, _PLAIN_TC,
                _PLAIN_TC // 2 + 1, time_packed=True)
        return self._plain

    def expected(self, tc: int, k: int) -> tuple:
        slots, nclose, state = self.plain()
        return (*reslot(slots, nclose, _PLAIN_TC, tc, k), state)

    def launch(self, cand: dict, state):
        return tpg.process_window(
            self.feed, state, self.cfg, cand["tc"], cand["k"],
            time_packed=True, fir_twopass=cand.get("twopass", 0),
            geometry=geometry_of(cand))


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def ptxas_of(geometry: Geometry):
    """The registers (min, max) of the tpg library of a geometry, its
    largest spill stores in bytes and how many kernels spill, from the
    ``ptxas -v`` report of its build in this process, or None when it was
    not built here."""
    log = _build.build_log.get(_build.log_key(
        "tpg", tpg.geometry_defines(geometry)))
    if not log:
        return None
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "registers": [min(regs), max(regs)],
            "spill_stores_max": max(spills, default=0),
            "spilling_kernels": sum(1 for s in spills if s)}


def measure_candidates(fam: Family, cands, windows: int, trials: int,
                       log=print, passes: int = 1, check: bool = True,
                       reference: dict | None = None) -> list:
    """Run every candidate once (and, with ``check``, hold its first
    window to the plain version at its tc and k and to the shipped
    geometry's outputs, ``reference``), then time chains of ``windows``
    launches carrying state, in rotated order, ``trials`` per pass.
    Returns the rows with ``ms`` (median ms per window over all passes),
    ``gsps`` and, with passes > 1, ``ms_passes``.  A skipped candidate
    (:func:`skip_reason`) is logged and left out; a build or launch error
    raises."""
    dev = fam.state.device
    cuda = dev.type == "cuda"
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.int32, device=dev) \
        if cuda else None
    reference = {} if reference is None else reference
    runs = []
    for cand in cands:
        why = skip_reason(fam.alg, cand, fam.T)
        if why is not None:
            log(f"#   skip {fam.alg} {cand}: {why}")
            continue
        got = fam.launch(cand, fam.state)      # builds the geometry's library
        if check:
            if not _same(got, fam.expected(cand["tc"], cand["k"])):
                raise AssertionError(f"{fam.alg} {cand}: the kernel differs "
                                     "from the plain version")
            key = (cand["tc"], cand["k"], cand.get("twopass", 0))
            if key in reference and not _same(got, reference[key]):
                raise AssertionError(f"{fam.alg} {cand}: the geometry's "
                                     "outputs differ from the shipped one's")
            if geometry_of(cand) == SHIPPED_GEOMETRY:
                reference[key] = got
        runs.append({"cand": cand, "ms": [[] for _ in range(passes)]})

    def chain(cand) -> float:
        if cuda:
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        s = fam.state
        for _ in range(windows):
            s = fam.launch(cand, s)[2]
        if not cuda:
            return (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    rot = 0
    for p in range(passes):
        for _ in range(trials):
            order = runs[rot % len(runs):] + runs[:rot % len(runs)] \
                if runs else []
            rot += 1
            for r in order:
                r["ms"][p].append(chain(r["cand"]) / windows)

    out = []
    for r in runs:
        flat = [m for ps in r["ms"] for m in ps]
        ms = float(statistics.median(flat)) if flat else float("nan")
        row = dict(r["cand"]) | {
            "ms": round(ms, 4),
            "gsps": round(fam.T * fam.C / ms / 1e6, 1) if ms == ms
            else None}
        if passes > 1:
            row["ms_passes"] = [round(float(statistics.median(ps)), 4)
                                if ps else float("nan") for ps in r["ms"]]
        out.append(row)
    return out


def knobs_of(row: dict, keys) -> dict:
    return {k: row[k] for k in keys if k in row}


def confirm_stage(alg: str, ok: list, sweep_winner: dict, measure,
                  n_confirm: int, log=print) -> dict:
    """The twice-confirmed rule (``_confirm_stage`` :156-213): re-measure
    the sweep's ``n_confirm`` best and the shipped knobs in two passes
    (``measure(finalists, passes=2)``); the tuned entry takes a
    challenger's knobs only if it beat the shipped knobs by more than 2%
    in both passes, else the shipped knobs, with the evidence under
    'confirm'.  When the shipped arm does not measure, the entry stays the
    shipped knobs, unconfirmed, with the sweep winner beside it."""
    shipped = shipped_knobs(alg)
    keys = tuple(k for k in KNOB_KEYS if k in shipped)
    finalists, seen = [], set()
    for row in sorted(ok, key=lambda r: r["ms"])[:n_confirm]:
        cand = knobs_of(row, keys)
        key = tuple(sorted(cand.items()))
        if key not in seen:
            seen.add(key)
            finalists.append(cand)
    ship_key = tuple(sorted(shipped.items()))
    if ship_key not in seen:
        finalists.append(shipped)
    log(f"# confirming {alg}: {len(finalists)} arms x 2 passes")
    rows = measure(finalists, passes=2)
    for r in rows:
        log(json.dumps({"alg": alg, "confirm": True, **r}))
    by_key = {tuple(sorted(knobs_of(r, keys).items())): r for r in rows}
    ship_row = by_key.get(ship_key)
    evidence = [r for r in rows if r["ms"] == r["ms"]]
    if ship_row is None or ship_row["ms"] != ship_row["ms"]:
        return dict(shipped) | {"confirmed": False, "confirm": evidence,
                                "sweep_winner": sweep_winner}
    challengers = [
        r for r in evidence
        if tuple(sorted(knobs_of(r, keys).items())) != ship_key
        and all(m == m and s == s and m < 0.98 * s for m, s in
                zip(r["ms_passes"], ship_row["ms_passes"]))]
    if challengers:
        best = min(challengers, key=lambda r: r["ms"])
        return knobs_of(best, keys) | {"gsps": best["gsps"],
                                       "confirmed": True,
                                       "confirm": evidence}
    return knobs_of(ship_row, keys) | {"gsps": ship_row["gsps"],
                                       "confirmed": False,
                                       "confirm": evidence}


def run(device=None, algs=ALGS, quick: bool = False, geometries=None,
        C: int = 2560, T: int = 8192, windows: int = 16, trials: int = 3,
        confirm: int = 0, confirm_trials: int = 4, check: bool = True,
        log=print) -> dict:
    """Sweep every family of ``algs`` and return {"tuned": {alg: entry},
    "sweep": {alg: rows}, "ptxas": {geometry: registers and spills}}.
    ``device`` None is the card ("cuda:0"), which must be there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("autotune needs a CUDA card (device='cpu' "
                               "runs the plain versions, for the tests)")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA card")
    winners, sweeps = {}, {}
    for alg in algs:
        log(f"# tuning {alg}")
        fam = Family(alg, C, T, dev)
        reference: dict = {}

        def measure(cands, passes=1, n=trials):
            return measure_candidates(fam, cands, windows, n, log, passes,
                                      check, reference)
        results = measure(space(alg, quick, geometries))
        for r in sorted(results, key=lambda r: r["ms"]):
            log(json.dumps({"alg": alg, **r}))
        sweeps[alg] = results
        ok = [r for r in results if r["ms"] == r["ms"]]
        if not ok:
            continue
        best = min(ok, key=lambda r: r["ms"])
        keys = tuple(k for k in KNOB_KEYS if k in best)
        winners[alg] = knobs_of(best, keys) | {"gsps": best["gsps"]}
        if confirm:
            winners[alg] = confirm_stage(
                alg, ok, winners[alg],
                lambda cands, passes: measure(cands, passes, confirm_trials),
                confirm, log)
    ptxas = {",".join(map(str, g)): ptxas_of(g)
             for g in geometry_space(quick, geometries)}
    return {"tuned": winners, "sweep": sweeps, "ptxas": ptxas}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", choices=ALGS, default=None,
                    help="tune one family (default: all four)")
    ap.add_argument("--out", default=None, help="write the tuned file here")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--geometry", action="append", default=None,
                    metavar="G,T,S", help="a geometry (group, stage_ticks, "
                    "stages) to sweep beside the shipped one, in place of "
                    "the default list; repeat for more")
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--confirm", type=int, default=0, metavar="N",
                    help="re-measure the N best against the shipped knobs "
                    "in two rotated passes (the twice-confirmed rule)")
    ap.add_argument("--confirm-trials", type=int, default=4)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the plain-version check of each candidate")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions (tests only)")
    args = ap.parse_args(argv)
    geoms = None if args.geometry is None else [
        Geometry(*map(int, g.split(","))) for g in args.geometry]
    res = run(args.device, [args.alg] if args.alg else ALGS, args.quick,
              geoms, args.channels, args.ticks, args.windows, args.trials,
              args.confirm, args.confirm_trials, not args.no_check,
              log=lambda s: print(s, file=sys.stderr, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res["tuned"], f, indent=2)
    print(json.dumps({"tuned": res["tuned"], "ptxas": res["ptxas"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
