"""The system ``WIBFrameProcessor`` x 10: one ProtoDUNE-SP APA's ProtoWIB
superchunks -> TPs and TPSets, each link its own processor and its own
``WIBTPHandler``, on the time2 feed.

A step hands one batch of every link to that link's ``process`` in turn,
on one host thread; each call is synchronous (its compact-hit fetches
wait for the device), so each step delivers one APA-batch.  The TPSets
each handler sends during a step are kept with that step.

The comparison follows runs of three batches as ``apa_app`` does: the
stream's start, the window's last, and ``DRAWN_RUNS`` drawn inside the
window from the seed by a reservoir sample.  A drawn run starts from the
program's state at its first batch: both planes' state rows, and each
link handler's buffered TPs and next sequence number.  The reference
(``reference/protowib``) follows every run over every link and plane in
forked workers, each taking a share of the (run, link) lanes on the
channel axis.
"""

from __future__ import annotations

import gc
import os

import numpy as np
import torch
from torch.profiler import record_function

from .. import judge, roofline
from ..reference.protowib import fir_iqr, frames, wib_tpsets

RUN_BATCHES = 3          # batches in each run the reference follows
DRAWN_RUNS = 12          # runs drawn inside the window
KEEP_BACK = 8            # recent batches whose state and TPSets are kept
RING_SLABS = 4           # distinct slabs the source cycles through

# the processor's state rows (ops/chanstate FIELDS order, the memory
# factor, then the FIR ring oldest first) of the fields the FIR family
# carries, by the reference's names
STATE_ROWS = {"pedestal": 0, "accum": 1, "prev_over": 5, "charge": 6,
              "tover": 7, "q25": 10, "q75": 11, "accum25": 12,
              "accum75": 13}
RING_ROW0 = 15

# the processors' counts a step reads: dropped hits of each plane (the
# processor's ``tpg_counts``, which a program without them lacks), dropped
# hits in all and suppressed TPs
PLANE_DROPS = ("num_hits_dropped_collection", "num_hits_dropped_induction")
COUNTERS = ("num_hits_dropped", "num_tps_suppressed_too_long")


def plane_counts(p):
    """A processor's counts of its TPG path, or None where it keeps none."""
    return getattr(p, "tpg_counts", None)

# settings the processors fix themselves, each read back from the
# processors built: the configuration has to state what the program runs
SETTINGS = {
    "collection_threshold": lambda p: p.coll_threshold,
    "induction_threshold": lambda p: p.ind_threshold,
    "k_slots": lambda p: p.k_slots,
    "tp_timeout": lambda p: p.tp_handler.tp_timeout,
    "tpset_window_size": lambda p: p.tp_handler.tpset_window_size,
    "min_collection_offline": lambda p: p.min_collection_offline,
    "min_induction_offline": lambda p: p.min_induction_offline,
    "tpg_backend": lambda p: p.backend,
}


def n_apas(config: dict) -> int:
    return 1


def min_ring(config: dict, traffic: dict) -> int:
    """The processors keep no frame past their call."""
    return RING_SLABS


def batch_seconds(config: dict, traffic: dict) -> float:
    """``frames_per_batch`` ticks of 25 clocks at 50 MHz."""
    return int(traffic["frames_per_batch"]) * frames.CLOCKS_PER_TICK \
        / frames.CLOCK_HZ


def least_bytes(config: dict, traffic: dict, hits_per_batch: float) -> float:
    """256 channels a link, a tick a frame: 12-bit samples, the FIR+IQR
    state the reference carries (9 fields and the 8-sample ring) read and
    written once, the hit records."""
    return roofline.least_bytes(
        config["links"] * frames.CHANNELS, traffic["frames_per_batch"],
        hits_per_batch, sample_bits=frames.ADC_BITS,
        state_words_read=fir_iqr.STATE_WORDS,
        state_words_written=fir_iqr.STATE_WORDS)


def max_hits(config: dict, C: int) -> int:
    return max(config["max_hits_floor"], config["max_hits_per_channel"] * C)


def chunk_ticks(T: int, cap: int) -> int:
    """The chunk the processor's time2 feed runs a batch of T ticks in: the
    largest divisor of T not above the cap, made even."""
    from fdreadoutlibs_tpu_torch.ops.tpg import auto_tc
    tc = auto_tc(T, cap=cap)
    if tc % 2:
        tc = next((d for d in range(tc, 1, -1)
                   if T % d == 0 and d % 2 == 0), T)
    return tc


class _Sink:
    """A handler's TPSet sink: keeps what it is sent until drained."""

    def __init__(self):
        self.sets = []

    def try_send(self, tpset) -> bool:
        self.sets.append(tpset)
        return True

    def drain(self) -> list:
        out, self.sets = self.sets, []
        return out


def tpset_of(s) -> dict:
    """A program TPSet -> the reference's dict form."""
    return {"seqno": int(s.seqno), "type": int(s.type),
            "origin": int(s.origin), "run_number": int(s.run_number),
            "start_time": int(s.start_time), "end_time": int(s.end_time),
            "objects": {f: s.objects[f].astype(np.int64)
                        for f in wib_tpsets.TP_FIELDS}}


def _tps_of(arr: np.ndarray) -> dict:
    """Buffered TP records (the port's TP dtype) -> int64 tensors."""
    return {f: torch.from_numpy(arr[f].astype(np.int64))
            for f in wib_tpsets.TP_FIELDS}


class System:
    def __init__(self, config: dict, traffic: dict, source, device):
        from fdreadoutlibs_tpu_torch.ops.config import Algorithm, TPGConfig
        from fdreadoutlibs_tpu_torch.stream.protowib import WIBFrameProcessor
        from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
        from fdreadoutlibs_tpu_torch.utils.tuning import kernel_knobs
        self.config, self.traffic, self.source = config, traffic, source
        self.L, self.T = config["links"], traffic["frames_per_batch"]
        if config["feed"] != "time2":
            raise ValueError(f"this module runs the time2 feed, not feed "
                             f"{config['feed']!r}")
        self.sinks = [_Sink() for _ in range(self.L)]
        self.procs = []
        for link, sink in enumerate(self.sinks):
            p = WIBFrameProcessor(
                tp_handler=WIBTPHandler(tpset_sink=sink, source_id=link),
                device=device)
            p.conf({"enable_tpg": True,
                    "tpg_backend": config["tpg_backend"],
                    "tpg_time2_feed": True, "link_id": link,
                    "crate_id": config["crate"]})
            p.start()
            self.procs.append(p)
        knobs = kernel_knobs(TPGConfig(algorithm=Algorithm.FIR))
        for p in self.procs:
            ran = {k: read(p) for k, read in SETTINGS.items()}
            ran["tc"] = chunk_ticks(self.T, knobs["tc"])
            ran["fir_twopass"] = knobs["fir_twopass"]
            for key, value in ran.items():
                if value != config[key]:
                    raise RuntimeError(f"the processors run {key} {value}, "
                                       f"the configuration states "
                                       f"{config[key]}")
        self.device = device
        self.b = 0
        self.starts = {}          # batch -> each link's state at its start
        self.sets = {}            # batch -> each link's TPSets sent in it
        self.dropped = {}         # batch -> (L, 2) dropped hits a plane
        self.dropped_link = {}    # batch -> dropped hits, every batch
        # do the processors count each plane's dropped hits?
        self.per_plane = all(plane_counts(p) is not None for p in self.procs)
        self.suppressed = {}      # batch -> (L,) TPs suppressed a link
        self.log = []             # (APA, batch) delivered since start_window
        self.rows = None          # the window's APA-batch timing rows
        self.kept = [0]           # first batches of the runs kept
        self.drawn = []           # the reservoir of runs drawn in the window
        self.rng = None           # the reservoir's draws, while sampling

    # ---- the program's steps ------------------------------------------
    def _snapshot(self, b: int) -> None:
        """Each link's state at the start of batch ``b``: both planes'
        state rows (None before the first batch seeds them), its handler's
        buffered TPs and next sequence number."""
        self.starts[b] = [
            (p._coll_stack, p._ind_stack, p.tp_handler._buffer.snapshot(),
             p.tp_handler.next_tpset_seqno) for p in self.procs]

    def _counts(self) -> np.ndarray:
        """(L, 4): dropped hits of each plane (0 where the processors do
        not count them) and in all, suppressed TPs."""
        return np.array([[(plane_counts(p) or {}).get(n, 0)
                          for n in PLANE_DROPS]
                         + [p.metrics.count(n) for n in COUNTERS]
                         for p in self.procs], dtype=np.int64)

    def _offer(self, b0: int) -> None:
        """Run b0 .. b0 + 2, now that the state after it is known, into
        the reservoir (each run of the window kept with equal chance)."""
        i = self.offered
        self.offered += 1
        if i < DRAWN_RUNS:
            self.drawn.append(b0)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < DRAWN_RUNS:
                self.drawn[j] = b0

    def _prune(self) -> None:
        """Forget what no kept run and none of the last ``KEEP_BACK``
        batches need."""
        runs = self.kept + self.drawn

        def wanted(k):
            return k >= self.b - KEEP_BACK or any(
                r <= k <= r + RUN_BATCHES for r in runs)
        for d in (self.starts, self.sets, self.dropped, self.suppressed):
            for k in [k for k in d if not wanted(k)]:
                del d[k]

    def _row(self) -> None:
        """One APA-batch row: the ten links' rows of this batch summed
        (none where the processors keep no rows).  Under the APA app's
        names, for the reader of the unnamed host time: ``step_ms`` the
        calls' walls, ``preprocess_ms`` their checks, and no retention or
        words copy, stages this path does not have."""
        rows = [p.batch_timings[-1] for p in self.procs
                if getattr(p, "batch_timings", None)]
        if len(rows) == self.L:
            keys = set(rows[0]).intersection(*rows[1:])
            row = {k: sum(r[k] for r in rows) for k in keys}
            if "total_ms" in row and "checks_ms" in row:
                row.update(step_ms=row["total_ms"],
                           preprocess_ms=row["checks_ms"],
                           retention_ms=0.0, words_ms=0.0)
            self.rows.append(row)

    def step(self) -> int:
        b = self.b
        with record_function("tpgbench.source"):
            batch = self.source.batch(0, b)
        self._snapshot(b)
        if self.rng is not None and b - RUN_BATCHES >= self.window_lo:
            self._offer(b - RUN_BATCHES)
        before = self._counts()
        for link, p in enumerate(self.procs):
            p.process(batch[link])
        counts = self._counts() - before
        # a link-plane where the processors count each plane, else a link
        self.dropped[b] = counts[:, :2] if self.per_plane else counts[:, 2:3]
        self.dropped_link[b] = int(counts[:, 2].sum())
        self.suppressed[b] = counts[:, 3]
        self.sets[b] = [sink.drain() for sink in self.sinks]
        if self.rows is not None:
            self._row()
        self.b += 1
        self._prune()
        self.log.append((0, b))
        return 1

    def start_window(self, seed: int) -> None:
        self.rows = []
        self.log = []
        self.window_lo = self.b
        self.rng = np.random.default_rng([int(seed), 1])
        self.offered = 0

    def stop_window(self) -> list:
        """The window's deliveries, (APA, batch); keeps its rows."""
        self.window_rows, self.rows = self.rows, None
        self.window = (self.log[0][1], self.log[-1][1])
        self.rng = None
        self.kept.append(self.window[1] - 2)
        return list(self.log)

    def finish(self) -> None:
        """Nothing is in flight; keep the state after the last batch."""
        self._snapshot(self.b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dropped_of(self, apa: int, b: int) -> int:
        return self.dropped_link[b]

    def layer_record(self) -> dict:
        return {"batch_timings": self.window_rows}

    def hits_total(self) -> int:
        """Hits the processors have fetched from the device so far."""
        return sum(int(p.get_info().get("num_hits", 0)) for p in self.procs)

    # ---- the comparison with the plain reference ----------------------
    def runs(self) -> list[int]:
        """First batches of the runs the reference follows: the stream's
        start, those drawn from the seed inside the window, and the
        window's last."""
        lo, hi = self.window
        if hi - 2 <= lo:
            raise RuntimeError(f"the window delivered {hi - lo + 1} batches; "
                               "the comparison needs four")
        return sorted(set(self.kept + self.drawn))

    def _lane_state(self, b: int, link: int) -> dict:
        """Link ``link``'s state rows at the start of batch ``b`` in the
        reference's layout: collection positions, then induction."""
        coll, ind = self.starts[b][link][:2]
        rows = torch.cat([coll.cpu(), ind.cpu()], dim=1).to(torch.int32)
        st = {f: rows[i].clone() for f, i in STATE_ROWS.items()}
        st["ring"] = rows[RING_ROW0:RING_ROW0 + fir_iqr.N_TAPS].clone()
        return st

    def outputs(self) -> dict:
        """The program's outputs over the batches the runs cover."""
        return {"sets": {b: [[tpset_of(s) for s in sets] for sets in link]
                         for b, link in self.sets.items()},
                "dropped": self.dropped,
                "suppressed": self.suppressed,
                "states": {b: [self._lane_state(b, link)
                               for link in range(self.L)]
                           for b in self.starts
                           if self.starts[b][0][0] is not None}}

    def reference_outputs(self, starts: list[int],
                          sample_mask: int = -1) -> dict:
        """The plain reference's TPSets, dropped and suppressed counts and
        end states of the runs that begin at ``starts``."""
        cfg, L, T = self.config, self.L, self.T
        lanes = []
        for i, b0 in enumerate(starts):
            for link in range(L):
                lanes.append((i, b0, link,
                              None if b0 == 0 else self._lane_state(b0, link)))
        n = min(len(lanes), len(os.sched_getaffinity(0)))
        groups = [lanes[k::n] for k in range(n)]
        thresholds = torch.tensor(
            [cfg["collection_threshold"]] * cfg["collection_per_link"]
            + [cfg["induction_threshold"]] * cfg["induction_per_link"],
            dtype=torch.int32)
        _FOLLOW.update(source=self.source, mask=sample_mask, T=T,
                       thresholds=thresholds, tc=cfg["tc"],
                       k_slots=cfg["k_slots"])
        # what is garbage now is freed here: a forked worker that collected
        # a CUDA tensor would die in the free and leave the pool waiting
        gc.collect()
        gc.freeze()
        try:
            results = judge.map_forked(_follow, groups)
        finally:
            gc.unfreeze()
        followed = {}
        for group, out in zip(groups, results):
            for (i, _, link, _), res in zip(group, out):
                followed[i, link] = res
        offline = frames.offline_channels(cfg["min_collection_offline"],
                                          cfg["min_induction_offline"])
        spans = (slice(0, cfg["collection_per_link"]),
                 slice(cfg["collection_per_link"], frames.CHANNELS))
        out = {"sets": {}, "dropped": {}, "suppressed": {}, "states": {}}
        for i, b0 in enumerate(starts):
            handlers = []
            for link in range(L):
                if b0 == 0:
                    handlers.append(wib_tpsets.Handler(
                        cfg["tp_timeout"], cfg["tpset_window_size"], link))
                else:
                    _, _, buffered, seqno = self.starts[b0][link]
                    handlers.append(wib_tpsets.Handler(
                        cfg["tp_timeout"], cfg["tpset_window_size"], link,
                        seqno=seqno, buffered=_tps_of(buffered)))
            for k in range(RUN_BATCHES):
                b = b0 + k
                ts0 = self.source.batch_ts(b)
                now = ts0 + frames.CLOCKS_PER_TICK * T
                dropped = np.zeros((L, 2), dtype=np.int64)
                suppressed = np.zeros(L, dtype=np.int64)
                sets = []
                for link in range(L):
                    closes, nclose, _ = followed[i, link]
                    for plane, span in enumerate(spans):
                        hits, dropped[link, plane] = fir_iqr.batch_hits(
                            closes, nclose, ticks=slice(k * T, (k + 1) * T),
                            channels=span, tc=cfg["tc"],
                            k_slots=cfg["k_slots"],
                            max_hits=max_hits(cfg, span.stop - span.start))
                        tps = wib_tpsets.assemble(hits, ts0, offline[plane],
                                                  link)
                        suppressed[link] += handlers[link].insert(
                            tps, wib_tpsets.judged_at(tps, ts0))
                    sets.append(handlers[link].send(now))
                out["dropped"][b] = dropped
                out["suppressed"][b] = suppressed
                out["sets"][b] = sets
            out["states"][b0 + RUN_BATCHES] = [followed[i, link][2]
                                               for link in range(L)]
        return out

    def judge(self, outputs: dict | None = None) -> dict:
        """Readings of the program's outputs (or ``outputs`` put in its
        place) against the plain reference, each with its limit."""
        prog = self.outputs() if outputs is None else outputs
        ref = self.reference_outputs(self.runs())
        n_sets = sum(tpsets_differing(prog["sets"].get(b, [[]] * self.L), r)
                     for b, r in ref["sets"].items())
        dropped = sum(dropped_differing(prog["dropped"].get(b), d)
                      for b, d in ref["dropped"].items())
        suppressed = sum(int(np.abs(prog["suppressed"][b] - s).sum())
                         if b in prog["suppressed"] else int(s.sum()) + 1
                         for b, s in ref["suppressed"].items())
        states = 0
        for b, st in ref["states"].items():
            p = prog["states"].get(b)
            states += sum(states_differing(p[link] if p else None, s)
                          for link, s in enumerate(st))
        return {"tpset_records_differing": {"value": n_sets, "limit": 0},
                "dropped_differing": {"value": dropped, "limit": 0},
                "tps_suppressed_differing": {"value": suppressed,
                                             "limit": 0},
                "state_words_differing": {"value": states, "limit": 0}}

    def control_outputs(self, sample_mask: int) -> dict:
        """The plain reference in the program's place, on samples cut by
        ``sample_mask``: the control that the comparison must fail."""
        return self.reference_outputs(self.runs(), sample_mask)


def tpsets_differing(prog: list, ref: list) -> int:
    """Records differing between the TPSets one batch sent, link by link:
    a set on one side only counts one and its TPs, a set on both its
    header fields that differ and its TPs in one and not the other."""
    n = 0
    for p_sets, r_sets in zip(prog, ref):
        p = {s["seqno"]: s for s in p_sets}
        r = {s["seqno"]: s for s in r_sets}
        for seqno in p.keys() | r.keys():
            a, b = p.get(seqno), r.get(seqno)
            if a is None or b is None:
                n += 1 + len((a or b)["objects"]["time_start"])
                continue
            n += sum(a[k] != b[k] for k in ("type", "origin", "run_number",
                                            "start_time", "end_time"))
            n += judge.records_differing(a["objects"], b["objects"],
                                         wib_tpsets.TP_FIELDS)
    return n


def dropped_differing(prog, ref: np.ndarray) -> int:
    """Dropped hits differing over one batch's (L, 2) link-planes, or its
    links where the program counts (L, 1) links only (all of them, and one
    more, where it kept no count)."""
    if prog is None:
        return int(ref.sum()) + 1
    if prog.shape != ref.shape:
        ref = ref.sum(axis=1, keepdims=True)
    return int(np.abs(prog - ref).sum())


def states_differing(prog: dict | None, ref: dict) -> int:
    """State words differing (all of them where the program kept none)."""
    fields = fir_iqr.STATE_FIELDS + ("ring",)
    if prog is None:
        return sum(ref[f].numel() for f in fields)
    return sum(int((prog[f] != ref[f]).sum()) for f in fields)


# what the forked workers of the comparison read (judge.map_forked)
_FOLLOW: dict = {}


def _follow(group: list) -> list:
    """The reference over a share of the (run, link) lanes, side by side on
    the channel axis: [(run, first batch, link, the program's state at it
    or None to seed from the first tick)] -> [(closes, nclose, end state)]
    a lane, its channels the link's register positions."""
    torch.set_num_threads(1)
    f = _FOLLOW
    order = frames.register_channels()
    samples, states = [], []
    for _, b0, link, state in group:
        raw = np.concatenate([f["source"].slab(0, b)[link]
                              for b in range(b0, b0 + RUN_BATCHES)])
        adcs = frames.decode(torch.from_numpy(raw).view(
            -1, frames.FRAME_BYTES))[:, order] & f["mask"]
        samples.append(adcs)
        states.append(fir_iqr.seed_state(adcs[0]) if state is None
                      else state)
    C = frames.CHANNELS
    state = {k: torch.cat([s[k] for s in states], dim=-1)
             for k in states[0]}
    closes, nclose, end = fir_iqr.run(
        torch.cat(samples, dim=1), state, f["thresholds"].repeat(len(group)),
        tc=f["tc"], k_slots=f["k_slots"])
    out = []
    for j in range(len(group)):
        lane = (closes["channel"] >= j * C) & (closes["channel"] < (j + 1) * C)
        own = {k: v[lane] for k, v in closes.items()}
        own["channel"] = own["channel"] - j * C
        out.append((own, nclose[:, j * C:(j + 1) * C].clone(),
                    {k: v[..., j * C:(j + 1) * C].clone()
                     for k, v in end.items()}))
    return out
