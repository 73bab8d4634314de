"""The emission layouts A/B: the direct store against ``SLOT_WORD_CARRY`` —
counterpart of ``scripts/bench_stepform_ab.py --mode slots`` (:151-154).

    python -m fdreadoutlibs_tpu_torch.probes.slots_ab [--datapaths all]

Per case three arms on the same inputs: ``A_stacked`` (the shipped direct
store; the JAX package's stacked default), ``A2_null`` (the same kernel
again: its spread against A is the run's noise floor) and ``B_word_carry``
(``tpg.SLOT_WORD_CARRY`` flipped for the launch and restored, as
``tests/test_tpg_pallas.py`` flips the JAX constant).  Slots, nclose and
carried state of B must equal A's bit for bit before anything is timed
(:205-211); then the arms are timed in rotated order.  The default cases are
the script's: the four families on the plain datapath at T=8192 x 2560 with
the tuned knobs and ``k_slots=1``; ``--datapaths all`` adds the other
datapaths the layout reaches (time2, frame words, words14 rows with their
gather and slab schedules, the int16 state, the FIR SWAR carry).  Only the
``slots`` mode is ported: the script's ``stepform`` arms re-write the tick's
source and are no kernel of their own.
"""

from __future__ import annotations

import argparse
import json
import statistics
from contextlib import contextmanager

import numpy as np
import torch

from . import event_ms, rotated
from ..ops import TPGConfig, ingest, init_chanstate, seed_chanstate, tpg
from ..testing import frame_words, time2_words
from ..utils.preflight import device_preflight
from ..utils.tuning import kernel_knobs

ARMS = ("A_stacked", "A2_null", "B_word_carry")
FAMILIES = ("SimpleThreshold", "AbsRS", "StandardRS", "FIR")


@contextmanager
def slot_word_carry(on: bool = True):
    """``tpg.SLOT_WORD_CARRY`` set for the block and restored."""
    orig = tpg.SLOT_WORD_CARRY
    tpg.SLOT_WORD_CARRY = on
    try:
        yield
    finally:
        tpg.SLOT_WORD_CARRY = orig


def family_cfg(fam: str) -> TPGConfig:
    """The script's configuration of a family (:170-172)."""
    if fam == "FIR":
        return TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    return TPGConfig.from_raw(fam, threshold=150)


def make_adcs(T: int, C: int, seed: int = 0) -> np.ndarray:
    """The script's window (:161-165): 900 + normal(0, 30) and 200 8-tick
    pulses of 300-3000 ADC."""
    rng = np.random.default_rng(seed)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(200):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    return adcs


def cases(datapaths: str = "plain", families=FAMILIES) -> list:
    """[(label, family, datapath)]: the script's (every family on the plain
    datapath), and with "all" the other datapaths the layout reaches."""
    out = [(f"{fam} plain", fam, "plain") for fam in families]
    if datapaths == "all":
        out += [(f"AbsRS {d}", "AbsRS", d) for d in (
            "time2", "frames", "words14", "words14 gather", "words14 slab",
            "int16")] + [("FIR plain fir_packed", "FIR", "fir_packed")]
    elif datapaths != "plain":
        raise ValueError(f"datapaths={datapaths!r}: expected plain or all")
    return out


def case_inputs(adcs: np.ndarray, cfg: TPGConfig, datapath: str, device):
    """(feed, state, keyword arguments of ``process_window``) of one
    case."""
    C = adcs.shape[1]
    int16 = datapath == "int16"
    state = tpg.pack_state(
        seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10),
        C, device=device, dtype=torch.int16 if int16 else torch.int32)
    kw = {"time_packed": False}
    if datapath in ("plain", "fir_packed"):
        feed = torch.from_numpy(adcs)
        if datapath == "fir_packed":
            kw["fir_packed"] = True
    elif int16:
        feed = torch.from_numpy(adcs.astype(np.int16))
    elif datapath == "time2":
        feed, kw = torch.from_numpy(time2_words(adcs)), {"time_packed": True}
    else:
        feed = torch.from_numpy(frame_words(adcs).view(np.int32))
        kw["packed14"] = "frames"
        if datapath.startswith("words14"):
            feed = ingest.pack_words14(feed)
            kw["packed14"] = "words14"
            if datapath != "words14":
                kw["words14_" + datapath.split()[1]] = True
    return feed.to(device), state, kw


def run(device=None, C: int = 2560, T: int = 8192, k_slots: int = 1,
        trials: int = 6, reps: int = 5, datapaths: str = "plain",
        families=FAMILIES) -> dict:
    """Every case: parity of the carry layout against the direct store,
    then ms per window per arm (means of ``reps`` launches by CUDA events,
    arms in rotated order over ``trials``).  On a CPU device the arms run
    the plain version, so a case gives its hits and dropped counts and no
    time."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    adcs = make_adcs(T, C)
    out = {}
    for label, fam, datapath in cases(datapaths, families):
        cfg = family_cfg(fam)
        knobs = kernel_knobs(cfg)
        feed, state, kw = case_inputs(adcs, cfg, datapath, dev)

        def window(carry: bool):
            with slot_word_carry(carry):
                return tpg.process_window(
                    feed, state, cfg, tpg.auto_tc(T, cap=knobs["tc"]),
                    k_slots, fir_twopass=knobs["fir_twopass"],
                    geometry=knobs["geometry"], **kw)
        first = {arm: window(arm == "B_word_carry")
                 for arm in ("A_stacked", "B_word_carry")}
        for a, b, what in zip(*first.values(), ("slots", "nclose", "state")):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {what} of the carry layout "
                                     "differ from the direct store's")
        hits = int((first["A_stacked"][0][:, :, -1] != 0).sum())
        if hits == 0:
            raise AssertionError(f"{label}: no hit closed")
        res = {"hits": hits,
               "dropped": int(torch.clamp(first["A_stacked"][1] - k_slots,
                                          min=0).sum())}
        out[label] = res
        if dev.type != "cuda":
            continue
        per = {arm: [] for arm in ARMS}
        for t in range(trials):
            for arm in rotated(ARMS, t):
                per[arm].append(event_ms(
                    lambda arm=arm: window(arm == "B_word_carry"), reps))
        for arm in ARMS:
            arr = sorted(per[arm])
            ms = statistics.median(arr)
            res[arm] = {"ms": ms,
                        "iqr_ms": [float(np.percentile(arr, 25)),
                                   float(np.percentile(arr, 75))],
                        "gsps": T * C / (ms * 1e-3) / 1e9}
            if arm != "A_stacked":
                res[arm]["vs_A"] = res["A_stacked"]["ms"] / ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", default="all",
                    help="SimpleThreshold|AbsRS|StandardRS|FIR|all")
    ap.add_argument("--datapaths", default="plain", choices=["plain", "all"])
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--k-slots", type=int, default=1)
    ap.add_argument("--trials", type=int, default=6)
    args = ap.parse_args(argv)
    info = device_preflight()
    fams = FAMILIES if args.alg == "all" else (args.alg,)
    out = run(None, args.channels, args.ticks, args.k_slots, args.trials,
              datapaths=args.datapaths, families=fams)
    out["device"] = info.get("nvidia_smi")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
