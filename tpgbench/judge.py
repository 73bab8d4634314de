"""Comparisons that decide ``correct``: the program's outputs against the
plain reference's, counted as differing records, sets, counts and state
words.  Every number has the limit 0 (an exact comparison)."""

from __future__ import annotations

import multiprocessing
import os
from collections import Counter

import numpy as np

from .reference import tpg
from .reference.tps import TP_FIELDS

# the readout's state rows (ops/chanstate FIELDS order, then the memory
# factor) that the AbsRS algorithm defines
STATE_ROWS = {"pedestals": 0, "accum": 1, "rs": 2, "pedestals_rs": 3,
              "accum_rs": 4, "hit_charge": 6, "hit_tover": 7,
              "hit_peak_adc": 8, "hit_peak_time": 9, "memory_factor": 14}


def state_from_rows(rows: np.ndarray) -> dict:
    """A readout state tensor's rows, as numpy (KSTATE, C) -> the
    reference's state dict."""
    return {f: rows[i].astype(np.int32) for f, i in STATE_ROWS.items()}


def records_differing(a: dict, b: dict, fields) -> int:
    """Records in one and not the other (multisets over ``fields``)."""
    ca = Counter(zip(*(np.asarray(a[f]).tolist() for f in fields)))
    cb = Counter(zip(*(np.asarray(b[f]).tolist() for f in fields)))
    return sum(((ca - cb) + (cb - ca)).values())


def states_differing(a: dict, b: dict) -> int:
    return int(sum(np.count_nonzero(np.asarray(a[f]) != np.asarray(b[f]))
                   for f in STATE_ROWS))


def tpset_records_differing(prog: dict, ref: dict) -> int:
    """Records differing over the sequence numbers ``ref`` holds: each TP
    in one set and not the other, each set whose header (type, start,
    end) differs, and a set the program did not emit with all its TPs."""
    n = 0
    for seqno, r in ref.items():
        p = prog.get(seqno)
        if p is None:
            n += 1 + len(r["objects"]["time_start"])
            continue
        n += int(any(p[k] != r[k] for k in ("type", "start_time",
                                              "end_time")))
        n += records_differing(p["objects"], r["objects"], TP_FIELDS)
    return n


def tpset_of(tpset) -> dict:
    """A program TPSet -> the reference's dict form."""
    objs = {k: tpset.objects[k].astype(np.int64) for k in TP_FIELDS}
    return {"seqno": int(tpset.seqno), "type": int(tpset.type),
            "start_time": int(tpset.start_time),
            "end_time": int(tpset.end_time), "objects": objs}


def hits_of(hits: np.ndarray) -> dict:
    """A program hit array -> the reference's dict form."""
    return {k: hits[k].astype(np.int64) for k in tpg.HIT_FIELDS}


def check_lines(readings: dict) -> list[str]:
    """One line a number: its name, the number and its limit."""
    return [f"check {name}: {v['value']} (limit {v['limit']})"
            for name, v in readings.items()]


def correct(readings: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in readings.values())


def map_forked(fn, items: list) -> list:
    """``[fn(x) for x in items]`` in forked worker processes, one a core:
    the workers read the parent's memory as it stood at the fork and touch
    no device.  Every worker has ended when this returns."""
    n = min(len(items), len(os.sched_getaffinity(0)))
    if n < 2:
        return [fn(x) for x in items]
    with multiprocessing.get_context("fork").Pool(n) as pool:
        out = pool.map(fn, items, chunksize=1)
        pool.close()
        pool.join()
    return out
