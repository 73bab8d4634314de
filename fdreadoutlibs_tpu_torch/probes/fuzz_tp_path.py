"""Adversarial fuzz of the host TP path — counterpart of ``scripts/fuzz_tp_path.py``.

It attacks what sits after TP emission, the port's ``tp/request_handler``
over ``tp/latency_buffer`` (the tardy and cutoff windowing and the ordered
latency buffer), with malformed, duplicate, unordered and tardy-boundary TP
streams, three ways (:8-25):

1. *differential*: every case drives two ``TPRequestHandler``s with one
   random operation sequence, one on the Python ``LatencyBuffer`` and one on
   the port's native buffer (``native/latency_buffer.cpp``), and the TPSet
   streams, tardy counts, request responses, occupancies and final buffer
   contents must be equal (as multisets where equal-key order is
   unspecified);
2. *invariants*, on both: cutoff and TPSet end monotonic, sequential
   seqnos, every shipped TP inside its window, TPs conserved (accepted ==
   retained + cleaned);
3. *hammer* (``--hammer N``): insert, pop, cleanup and query threads on
   one shared native buffer; the snapshot stays key-sorted and the
   occupancy equals inserts minus pops.

Host only: no kernel runs.  ``python -m fdreadoutlibs_tpu_torch.probes.
fuzz_tp_path --n 300 --start 56000 [--hammer 20]``; one JSON line per
failing case, then a summary; exit 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np

from .. import native
from ..formats.trigprim import TP_DTYPE, make_tps
from ..tp.latency_buffer import LatencyBuffer, NativeLatencyBufferAdapter
from ..tp.request_handler import TPRequestHandler


class ListSink:
    """Deterministic TPSet sink; optionally fails every k-th send."""

    def __init__(self, fail_every: int = 0):
        self.sets = []
        self.fail_every = fail_every
        self._n = 0

    def try_send(self, tpset) -> bool:
        self._n += 1
        if self.fail_every and self._n % self.fail_every == 0:
            return False
        self.sets.append(tpset)
        return True


def canon(tps: np.ndarray) -> np.ndarray:
    """Canonical total order over full records: equal-key relative order
    is unspecified between the two buffer implementations."""
    if len(tps) == 0:
        return tps
    order = np.lexsort(tuple(tps[n] for n in reversed(TP_DTYPE.names)))
    return tps[order]


def gen_batch(rng, clock: int, cutoff: int) -> np.ndarray:
    """One adversarial TP batch around the current stream clock/cutoff."""
    n = int(rng.integers(1, 40))
    tps = make_tps(n)
    kinds = rng.integers(0, 8, size=n)
    ts = np.empty(n, dtype=np.uint64)
    for i, k in enumerate(kinds):
        if k <= 2:                       # in-order-ish fresh TPs
            ts[i] = clock + int(rng.integers(0, 5000))
        elif k == 3:                     # deep tardy (before cutoff)
            ts[i] = max(0, cutoff - int(rng.integers(1, 1 << 20)))
        elif k == 4:                     # exact tardy boundary: == cutoff
            ts[i] = cutoff               # accepted ('< cutoff' is tardy)
        elif k == 5 and cutoff > 0:      # one tick inside tardy
            ts[i] = cutoff - 1
        elif k == 6:                     # duplicate of a fresh value
            ts[i] = clock + 64
        else:                            # hostile values
            ts[i] = rng.choice(np.array(
                [0, 1, (1 << 63), (1 << 64) - 1, (1 << 63) - 1],
                dtype=np.uint64))
    tps["time_start"] = ts
    tps["time_peak"] = ts + np.uint64(32)
    tps["time_over_threshold"] = rng.integers(32, 4096, size=n)
    tps["channel"] = rng.integers(0, 2560, size=n)
    tps["adc_integral"] = rng.integers(0, 1 << 20, size=n)
    tps["adc_peak"] = rng.integers(0, 16384, size=n)
    tps["detid"] = 3
    if rng.random() < 0.5:               # unordered delivery
        rng.shuffle(tps)
    return tps


def make_handler(native: bool, capacity, fail_every: int):
    buf = (NativeLatencyBufferAdapter(TP_DTYPE, capacity) if native
           else LatencyBuffer(capacity=capacity, dtype=TP_DTYPE))
    sink = ListSink(fail_every)
    h = TPRequestHandler(tpset_sink=sink, latency_buffer=buf)
    h.conf({"tpset_transmission_rate_hz": 1000,
            "tpset_min_latency_ticks": 5000,
            "tardy_tp_quiet_time_at_start_sec": 0})
    h.start(run_number=17)
    return h, sink


def run_case(seed: int, with_native: bool) -> dict:
    rng = np.random.default_rng(seed)
    capacity = int(rng.choice([0, 64, 4096]))  # 0 -> unbounded
    cap = capacity or None
    fail_every = int(rng.choice([0, 0, 0, 7]))
    n_ops = int(rng.integers(20, 70))

    handlers = [make_handler(False, cap, fail_every)]
    if with_native:
        handlers.append(make_handler(True, cap, fail_every))

    clock = 1 << 20
    accepted = inserted = cleaned = 0
    last_end = -1
    seq_expect = 0
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    for op_i in range(n_ops):
        op = rng.choice(["insert", "insert", "insert", "stream", "send",
                         "send", "cleanup_occ", "cleanup_ts", "request"])
        if op == "insert":
            batch = gen_batch(rng, clock, max(0, last_end))
            accs = [h.insert_tps(batch.copy()) for h, _ in handlers]
            check(len(set(accs)) == 1, f"op{op_i}: accept counts {accs}")
            accepted += accs[0]
            inserted += len(batch)
            clock += int(rng.integers(0, 4000))
        elif op == "stream":
            clock += int(rng.integers(0, 20000))
            for h, _ in handlers:
                h.note_stream_time(clock)
        elif op == "send":
            sets = [h.send_tp_sets_once() for h, _ in handlers]
            nones = [s is None for s in sets]
            check(len(set(nones)) == 1, f"op{op_i}: send disagree {nones}")
            if not any(nones):
                s0 = sets[0]
                for s in sets[1:]:
                    check((s.type, s.seqno, s.start_time, s.end_time)
                          == (s0.type, s0.seqno, s0.start_time,
                              s0.end_time),
                          f"op{op_i}: TPSet header mismatch")
                    check(np.array_equal(canon(s.objects),
                                         canon(s0.objects)),
                          f"op{op_i}: TPSet objects mismatch")
                # invariants.  end_time is non-DECREASING, not strictly
                # increasing: a boundary TP with ts == cutoff is accepted
                # (tardy is strictly '<') and TPCTPRequestHandler replaces the
                # window end with the last TP's ts (cpp:156-164), so an
                # emitted end can exactly repeat the previous one.
                check(s0.end_time >= last_end,
                      f"op{op_i}: end_time went backward")
                check(s0.seqno == seq_expect, f"op{op_i}: seqno gap")
                seq_expect += 1
                if len(s0.objects):
                    o = s0.objects["time_start"]
                    check(bool((o[:-1] <= o[1:]).all()),
                          f"op{op_i}: TPSet objects unsorted")
                    check(int(o[-1]) <= s0.end_time,
                          f"op{op_i}: object past window end")
                last_end = s0.end_time
                for h, _ in handlers:
                    check(h.cutoff_timestamp == s0.end_time,
                          f"op{op_i}: cutoff != window end")
        elif op == "cleanup_occ":
            occ = int(rng.integers(0, 256))
            drops = [h.cleanup(max_occupancy=occ) for h, _ in handlers]
            check(len(set(drops)) == 1, f"op{op_i}: cleanup drops {drops}")
            cleaned += drops[0]
        elif op == "cleanup_ts":
            span = int(rng.integers(1, 1 << 22))
            drops = [h.cleanup(max_ts_diff=span) for h, _ in handlers]
            check(len(set(drops)) == 1,
                  f"op{op_i}: ts cleanup drops {drops}")
            cleaned += drops[0]
        elif op == "request":
            a = clock - int(rng.integers(0, 1 << 21))
            b = a + int(rng.integers(0, 1 << 20))
            resps = [h.request(max(0, a), max(0, b)) for h, _ in handlers]
            for r in resps[1:]:
                check(np.array_equal(canon(r), canon(resps[0])),
                      f"op{op_i}: request response mismatch")

        occs = [h.buffer.occupancy() for h, _ in handlers]
        check(len(set(occs)) == 1, f"op{op_i}: occupancy diverged {occs}")

    # conservation + final content equality
    h0 = handlers[0][0]
    check(h0.buffer.occupancy() == accepted - cleaned,
          f"conservation: occ {h0.buffer.occupancy()} != "
          f"accepted {accepted} - cleaned {cleaned}")
    snaps = [h.buffer.snapshot() for h, _ in handlers]
    for s in snaps[1:]:
        check(np.array_equal(canon(s), canon(snaps[0])),
              "final buffer contents mismatch")
    keys = snaps[0]["time_start"]
    check(bool((keys[:-1] <= keys[1:]).all()), "final snapshot unsorted")
    tardies = [h.metrics.count("num_tps_suppressed_tardy")
               for h, _ in handlers]
    check(len(set(tardies)) == 1, f"tardy counts diverged {tardies}")

    return {"seed": seed, "capacity": capacity, "ops": n_ops,
            "accepted": accepted, "inserted": inserted,
            "tpsets": seq_expect, "failures": failures}


def run_hammer(seed: int, seconds: float = 1.0) -> dict:
    """Concurrent insert/extract/pop/cleanup/query hammer on ONE shared
    native buffer."""
    rng = np.random.default_rng(seed)
    buf = NativeLatencyBufferAdapter(TP_DTYPE)
    stop = threading.Event()
    inserted = np.zeros(4, dtype=np.int64)
    popped = np.zeros(2, dtype=np.int64)
    errors = []

    def inserter(i):
        r = np.random.default_rng(seed * 100 + i)
        base = 1 << 20
        try:
            while not stop.is_set():
                n = int(r.integers(1, 64))
                tps = make_tps(n)
                tps["time_start"] = base + r.integers(0, 1 << 18, size=n)
                buf.insert(tps)
                inserted[i] += n
                base += int(r.integers(0, 1024))
        except Exception as e:  # noqa: BLE001
            errors.append(f"inserter{i}: {e!r}")

    def popper(i):
        r = np.random.default_rng(seed * 200 + i)
        try:
            while not stop.is_set():
                if r.random() < 0.5:
                    popped[i] += buf.pop_n(int(r.integers(0, 32)))
                else:
                    popped[i] += buf.cleanup_max_ts_diff(
                        int(r.integers(1 << 16, 1 << 20)))
        except Exception as e:  # noqa: BLE001
            errors.append(f"popper{i}: {e!r}")

    def reader():
        r = np.random.default_rng(seed * 300)
        try:
            while not stop.is_set():
                lo = buf.oldest_ts()
                buf.newest_ts()
                buf.occupancy()
                buf.key_at(int(r.integers(0, 1 << 12)))
                if lo is not None:
                    w = buf.extract_window(lo, lo + (1 << 17))
                    k = w["time_start"]
                    if len(k) > 1 and not (k[:-1] <= k[1:]).all():
                        errors.append("reader: unsorted window")
                        return
        except Exception as e:  # noqa: BLE001
            errors.append(f"reader: {e!r}")

    threads = [threading.Thread(target=inserter, args=(i,))
               for i in range(2)]
    threads += [threading.Thread(target=popper, args=(i,))
                for i in range(2)]
    threads += [threading.Thread(target=reader)]
    for t in threads:
        t.start()
    stop.wait(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    failures = list(errors)
    occ = buf.occupancy()
    expect = int(inserted.sum() - popped.sum())
    if occ != expect:
        failures.append(f"hammer conservation: occ {occ} != {expect}")
    snap = buf.snapshot()
    k = snap["time_start"]
    if len(k) > 1 and not (k[:-1] <= k[1:]).all():
        failures.append("hammer: final snapshot unsorted")
    return {"seed": seed, "inserted": int(inserted.sum()),
            "popped": int(popped.sum()), "final_occ": occ,
            "failures": failures}


def sweep(n: int, start: int, hammer: int = 0, verbose: bool = False,
          log=print) -> dict:
    """``n`` differential cases from seed ``start``, then ``hammer``
    hammer cases (native buffer only); failing cases are reported (one JSON
    line each).  Returns the summary."""
    with_native = native.available()
    n_fail = 0
    for seed in range(start, start + n):
        res = run_case(seed, with_native)
        if res["failures"]:
            n_fail += 1
            log(json.dumps(res))
        elif verbose:
            log(json.dumps(res))
    hammer_fail = 0
    for i in range(hammer if with_native else 0):
        res = run_hammer(start + i)
        if res["failures"]:
            hammer_fail += 1
            log(json.dumps(res))
    return {"cases": n, "failures": n_fail, "differential": with_native,
            "hammer_cases": hammer if with_native else 0,
            "hammer_failures": hammer_fail,
            "seed_range": [start, start + n - 1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=56000)
    ap.add_argument("--hammer", type=int, default=0,
                    help="also N concurrency-hammer cases (~1 s each) on "
                    "the native buffer")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    res = sweep(args.n, args.start, args.hammer, args.verbose)
    print(json.dumps(res))
    return 1 if (res["failures"] or res["hammer_failures"]) else 0


if __name__ == "__main__":
    sys.exit(main())
