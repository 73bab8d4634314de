"""The system ``APAReadoutApp``: one APA's packed WIBEth batches -> TPs and
TPSets, on the time2 feed, with depth-2 pipelining.

``process_batch(b)`` submits batch b's device work and finishes batch
b - 1 (the compact-hit fetch, TP assembly, the TP latency buffer and one
TPSet emission), so each step delivers one batch.  The harness drains the
TPSet queue after every step, as the trigger downstream would.

The comparison follows runs of three batches: the stream's start, the
window's last, and ``DRAWN_RUNS`` drawn inside the window from the seed by
a reservoir sample as the window passes.  Only the states and TPSets of
those runs and of the last few batches are kept, so the window holds no
more memory at its end than at its start.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import judge, roofline
from ..reference import channels, frames, tpg, tps

CLOCK_HZ = 62.5e6        # the DAQ timestamp clock

# a TPSet window reaches back min_latency + one frame clocks; a batch must
# span more, so that a set holds TPs of two batches at most
REACH_BACK_CLOCKS = 20480 + frames.CLOCKS_PER_FRAME
RUN_BATCHES = 3          # batches in each run the reference follows
DRAWN_RUNS = 12          # runs drawn inside the window
KEEP_BACK = 8            # recent batches whose state and TPSet are kept

# settings the app fixes itself, each read back from the app built:
# the configuration has to state what the program runs
APP_SETTINGS = {
    "threshold": lambda app: app.cfg.threshold,
    "k_slots": lambda app: app.k_slots,
    "rs_memory_factor_x10": lambda app: app.cfg.rs_memory_factor_x10,
    "rs_scale_factor_x10": lambda app: app.cfg.rs_scale_factor_x10,
    "accumulator_limit": lambda app: app.cfg.accumulator_limit,
    "tp_timeout": lambda app: app.procs[0].tp_max_width,
    "tpset_min_latency_ticks": lambda app: app.handler.min_latency_ticks,
    "tpset_transmission_rate_hz":
        lambda app: 1_000_000 // app.handler.sender_sleep_us,
}


def n_apas(config: dict) -> int:
    return 1


def min_ring(config: dict, traffic: dict) -> int:
    """The raw retention holds up to capacity / frames-per-batch slabs, and
    the pipeline one more; one spare."""
    return config["raw_capacity_frames"] // traffic["frames_per_batch"] + 3


def batch_seconds(config: dict, traffic: dict) -> float:
    """``frames_per_batch`` WIBEth frames of 2048 clocks."""
    return int(traffic["frames_per_batch"]) * frames.CLOCKS_PER_FRAME \
        / CLOCK_HZ


def least_bytes(config: dict, traffic: dict, hits_per_batch: float) -> float:
    """64 channels a link, 64 ticks a frame, at the AbsRS count of
    ``roofline.least_bytes``'s defaults (14-bit samples, 10 state words
    read and 9 written)."""
    return roofline.least_bytes(
        config["links"] * frames.CHANNELS,
        traffic["frames_per_batch"] * frames.TICKS, hits_per_batch)


def max_hits(config: dict, C: int) -> int:
    return max(config["max_hits_floor"], config["max_hits_per_channel"] * C)


class System:
    def __init__(self, config: dict, traffic: dict, source, device):
        from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp
        from fdreadoutlibs_tpu_torch.utils.tuning import kernel_knobs
        self.config, self.traffic, self.source = config, traffic, source
        self.L, self.N = config["links"], traffic["frames_per_batch"]
        self.T = self.N * frames.TICKS
        if config["feed"] != "time2" or not config["pipelined"]:
            raise ValueError(f"this module runs the pipelined app on the "
                             f"time2 feed, not feed {config['feed']!r}, "
                             f"pipelined {config['pipelined']}")
        self.app = APAReadoutApp(
            n_links=self.L, algorithm=config["algorithm"],
            threshold=config["threshold"],
            threshold_on_collection=config["threshold_on_collection"],
            time2_feed=True, codec_threads=config["codec_threads"],
            batched_assembly=True,
            raw_capacity_frames=config["raw_capacity_frames"],
            raw_retention="zerocopy", pipelined=True,
            k_slots=config["k_slots"], device=device)
        ran = {k: read(self.app) for k, read in APP_SETTINGS.items()}
        ran["tc"] = kernel_knobs(self.app.cfg)["tc"]
        for key, value in ran.items():
            if key in config and value != config[key]:
                raise RuntimeError(f"the app runs {key} {value}, the "
                                   f"configuration states {config[key]}")
        self.b = 0
        self.states = {}          # batch -> state tensor it was given
        self.dropped = {}         # batch -> dropped count it delivered
        self.sets = {}            # seqno -> TPSet
        self.log = []             # (APA, batch) delivered since start_window
        self.kept = [0]           # first batches of the runs kept
        self.drawn = []           # the reservoir of runs drawn in the window
        self.rng = None           # the reservoir's draws, while sampling

    def _drain(self) -> None:
        for s in self.app.tpset_q.drain():
            self.sets[int(s.seqno)] = s

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
        """Forget the states and sets that no kept run and none of the
        last ``KEEP_BACK`` batches need."""
        runs = self.kept + self.drawn
        def wanted(k):
            return k >= self.b - KEEP_BACK or any(
                r <= k <= r + RUN_BATCHES + 1 for r in runs)
        for d in (self.states, self.sets):
            for k in [k for k in d if not wanted(k)]:
                del d[k]

    def step(self) -> int:
        b = self.b
        pending = self.app._pending is not None
        with record_function("tpgbench.source"):
            batch = self.source.batch(0, b)
        self.states[b] = self.app._state
        if self.rng is not None and b - RUN_BATCHES >= self.window_lo:
            self._offer(b - RUN_BATCHES)
        with record_function("APAReadoutApp.process_batch"):
            d = self.app.process_batch(batch)
        with record_function("tpgbench.drain"):
            self._drain()
        self.b += 1
        self._prune()
        if not pending:
            return 0
        self.dropped[b - 1] = d
        self.log.append((0, b - 1))
        return 1

    def start_window(self, seed: int) -> None:
        self.app.batch_timings.clear()
        self.log = []
        self.window_lo = self.b - 1
        self.rng = np.random.default_rng([int(seed), 1])
        self.offered = 0

    def stop_window(self) -> list:
        """The window's deliveries, (APA, batch); keeps its host timings."""
        self.window_timings = list(self.app.batch_timings)
        self.window = (self.log[0][1], self.log[-1][1])
        self.rng = None
        self.kept.append(self.window[1] - 2)
        return list(self.log)

    def finish(self) -> None:
        """Deliver the batch in flight and wait for the device."""
        if self.app._pending is not None:
            self.dropped[self.b - 1] = self.app.flush()
        self._drain()
        if self.app.device.type == "cuda":
            torch.cuda.synchronize(self.app.device)

    def dropped_of(self, apa: int, b: int) -> int:
        return self.dropped[b]

    def layer_record(self) -> dict:
        return {"batch_timings": self.window_timings}

    def hits_total(self) -> int:
        """Hits the program has fetched from the device so far."""
        return int(self.app.get_info()["total_hits"])

    # ---- the comparison with the plain reference ----------------------
    def runs(self) -> list[int]:
        """First batches of the runs the reference follows, three batches
        each: the stream's start (from the reference's own seeding), those
        drawn from the seed inside the window, and the window's last."""
        if self.T * frames.CLOCKS_PER_TICK <= REACH_BACK_CLOCKS:
            raise ValueError(f"batches of {self.T} ticks are no longer than "
                             "a TPSet window's reach back")
        lo, hi = self.window
        if hi - 2 <= lo:
            raise RuntimeError(f"the window delivered {hi - lo + 1} batches; "
                               "the comparison needs four")
        return sorted(set(self.kept + self.drawn))

    def outputs(self) -> dict:
        return {"sets": {k: judge.tpset_of(v) for k, v in self.sets.items()},
                "dropped": self.dropped, "states": self.states}

    def reference_outputs(self, starts: list[int],
                          sample_mask: int = -1) -> dict:
        """The plain reference's sets, dropped counts and end states of the
        runs that begin at ``starts``: the first from its own seeding, the
        others from the program's state at their first batch, windowed
        from the cutoff of the program's set before it."""
        cfg, C = self.config, self.L * frames.CHANNELS
        offline, coll = channels.link_channels(self.L, cfg["crate"])
        mf = channels.memory_factors(coll, cfg["rs_memory_factor_x10"],
                                     cfg["threshold_on_collection"])
        tc = tpg.chunk_ticks(self.T, cfg["tc"])
        jobs = []
        for b0 in starts:
            st = None
            if b0:
                st = judge.state_from_rows(self.states[b0].cpu().numpy())
                st["memory_factor"] = mf
            jobs.append((b0, st))
        _FOLLOW.update(source=self.source, mask=sample_mask, mf=mf,
                       params={"threshold": cfg["threshold"],
                               "accumulator_limit": cfg["accumulator_limit"],
                               "scale_x10": cfg["rs_scale_factor_x10"],
                               "tc": tc, "k_slots": cfg["k_slots"]})
        followed = judge.map_forked(_follow, jobs)
        lat = cfg["tpset_min_latency_ticks"]
        out = {"sets": {}, "dropped": {}, "states": {}}
        for b0, (closes, nclose, end_state) in zip(starts, followed):
            batch_tps = []
            for k in range(RUN_BATCHES):
                hits, dropped = tpg.batch_hits(
                    closes, nclose, ticks=slice(k * self.T, (k + 1) * self.T),
                    tc=tc, k_slots=cfg["k_slots"],
                    max_hits=max_hits(cfg, C))
                out["dropped"][b0 + k] = dropped
                t_base = np.full(self.L, self.source.batch_ts(b0 + k))
                batch_tps.append(tps.assemble(
                    hits, t_base, offline, cfg["det_id"], cfg["tp_timeout"]))
            stream = [self.source.batch_ts(b) + (self.N - 1)
                      * frames.CLOCKS_PER_FRAME
                      for b in range(b0, b0 + RUN_BATCHES)]
            if b0 == 0:
                w, first = tps.Windowing(lat), 0
            else:
                w = tps.Windowing(
                    lat, start=tps.window_end(batch_tps[0], stream[0], lat),
                    cutoff=int(self.sets[b0].end_time), seqno=b0 + 1,
                    buffered=batch_tps[0], stream=stream[0])
                first = 1
            for k in range(first, RUN_BATCHES):
                s = w.finish_batch(batch_tps[k], stream[k])
                if s is not None:
                    out["sets"][s["seqno"]] = s
            out["states"][b0 + RUN_BATCHES] = end_state
        return out

    def judge(self, outputs: dict | None = None) -> dict:
        """Readings of the program's outputs (or ``outputs`` put in its
        place) against the plain reference, each with its limit."""
        prog = self.outputs() if outputs is None else outputs
        ref = self.reference_outputs(self.runs())
        n_sets = judge.tpset_records_differing(prog["sets"], ref["sets"])
        states = 0
        for b, st in ref["states"].items():
            p = prog["states"][b]
            if isinstance(p, torch.Tensor):
                p = judge.state_from_rows(p.cpu().numpy())
            states += judge.states_differing(p, st)
        dropped = sum(abs(prog["dropped"].get(b, -1) - d)
                      for b, d in ref["dropped"].items())
        return {"tpset_records_differing": {"value": n_sets, "limit": 0},
                "dropped_differing": {"value": dropped, "limit": 0},
                "state_words_differing": {"value": states, "limit": 0}}

    def control_outputs(self, sample_mask: int) -> dict:
        """The plain reference in the program's place, on samples cut by
        ``sample_mask``: the control that the comparison must fail."""
        return self.reference_outputs(self.runs(), sample_mask)


# what the forked workers of the comparison read (judge.map_forked)
_FOLLOW: dict = {}


def _follow(job):
    """The reference over one run: (first batch, the program's state at it
    or None to seed from the first tick) -> (closes, nclose, end state)."""
    b0, state = job
    f = _FOLLOW
    adcs = np.concatenate([frames.unpack_adcs(f["source"].slab(0, b))
                           for b in range(b0, b0 + RUN_BATCHES)]) & f["mask"]
    if state is None:
        state = tpg.seed_state(adcs[0], f["mf"])
    return tpg.run(adcs, state, **f["params"])
