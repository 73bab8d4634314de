"""One run of one cell: set-up, warm-up, a measured window, an optional
traced segment, the comparison with the plain reference, and one result
line.

    python3 -m tpgbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<name>.json``, whose ``system``
names the port's entry point in ``systems/``) and a traffic mix
(``traffic/<name>.json``); each metric the cell reports is read by
``metrics/<name>.py`` from the run's record.  With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy and window seconds and a breakdown.  The
comparison's numbers, each beside its limit, end standard error and the
line.  Without a CUDA card, or with fewer than the cell asks for, the run
prints no result and exits 2; with JAX or the JAX package loaded after
the window, 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

WARM_STEPS = 3           # pipeline fill, library loads, lazy tables
TRACE_STEPS = 48         # steps in the traced segment
BANNED = ("jax", "jaxlib", "flax", "fdreadoutlibs_tpu")
CACHE_DIR = ".tpgbench_cache"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m tpgbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def pin_caches(root) -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    base = os.path.join(str(root), CACHE_DIR)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


class Run:
    """Set-up and the measured window of one cell; what the metric
    readers read."""

    def __init__(self, bench: dict, cell: str, seed: int, device,
                 overrides: dict | None = None, t_start: float | None = None):
        from . import spec
        self.t_start = time.monotonic() if t_start is None else t_start
        self.phases = {"imports": self._since_start()}
        self.cell = spec.workload(bench, cell)
        self.config = dict(spec.configuration(bench, self.cell["config"]))
        self.traffic = dict(spec.traffic(self.cell["traffic"]))
        for key, value in (overrides or {}).items():
            (self.traffic if key in self.traffic else self.config)[key] = value
        self.mod = spec.system(self.config["system"])
        self.seed = seed
        self.device = device
        self.apas = self.mod.n_apas(self.config)
        ring = self.mod.min_ring(self.config, self.traffic)
        gen = spec.generator(self.traffic["generator"])
        self.source = gen.Source(self.config, self.traffic, seed, device,
                                 self.apas, ring)
        self._sync()
        self.phases["traffic"] = self._since_start()
        self.system = self.mod.System(self.config, self.traffic, self.source,
                                      device)
        self.phases["system"] = self._since_start()
        self.batch_s = self.mod.batch_seconds(self.config, self.traffic)
        self.trace = None

    def _since_start(self) -> float:
        return round(time.monotonic() - self.t_start, 3)

    def warm(self, steps: int = WARM_STEPS) -> None:
        """Warm-up steps; the device's peak memory counts from their end,
        so that it is the program's and not the traffic generator's."""
        for _ in range(steps * self.apas):
            self.system.step()
        self._sync()
        if self.device.type == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.monotonic() - self.t_start
        self.phases["warm"] = round(self.setup_s, 3)

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        """Steps until ``seconds`` have passed; the window ends when the
        last step returns.  ``deliveries`` are the APA-batches whose hits
        or TPs came back inside it."""
        self.system.start_window(self.seed)
        t0 = time.perf_counter()
        t1 = t0
        while t1 - t0 < seconds:
            self.system.step()
            t1 = time.perf_counter()
        self.window_s = t1 - t0
        self.deliveries = self.system.stop_window()
        self.layer = self.system.layer_record()

    def traced(self, steps: int = TRACE_STEPS) -> None:
        """A segment of ``steps`` steps after the window under the
        profiler; the hits it fetched go with it, and the least bytes the
        system module counts for a batch of them."""
        from . import trace
        hits0 = self.system.hits_total()
        cap = trace.capture(steps, self.system.step)
        self.trace = trace.reduce(cap)
        self.trace["batches"] = steps
        self.trace["hits"] = self.system.hits_total() - hits0
        self.trace["least_bytes"] = self.mod.least_bytes(
            self.config, self.traffic, self.trace["hits"] / steps)

    def record(self) -> dict:
        rec = {"config": self.config, "traffic": self.traffic,
               "apas": self.apas, "batch_s": self.batch_s,
               "delivered": len(self.deliveries), "window_s": self.window_s,
               "setup_s": self.setup_s, "trace": self.trace}
        rec.update(self.layer)
        return rec

    def dropped(self) -> list[int]:
        """Dropped hits of each APA-batch delivered in the window."""
        return [self.system.dropped_of(a, b) for a, b in self.deliveries]


def metric_values(bench: dict, cell: str, rec: dict, trace: bool) -> dict:
    from . import spec
    out = {}
    for m in spec.metrics_of(bench, cell, trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, args, device, t_start: float,
             overrides: dict | None = None) -> dict:
    """The whole run; returns the result line as a dict."""
    from . import judge
    run = Run(bench, args.workload, args.seed, device, overrides, t_start)
    run.warm()
    print("tpgbench: set-up phases ended at (s) " + json.dumps(run.phases),
          file=sys.stderr)
    run.window(args.seconds)
    print(f"tpgbench: {len(run.deliveries)} batches delivered in "
          f"{run.window_s:.3f} s of window", file=sys.stderr)
    if args.trace:
        run.traced()
    run.system.finish()
    memory = 0
    if device.type == "cuda":
        import torch
        memory = int(torch.cuda.max_memory_allocated(device))
    t_judge = time.monotonic()
    readings = run.system.judge()
    print(f"tpgbench: the comparison took "
          f"{time.monotonic() - t_judge:.1f} s", file=sys.stderr)
    dropped = run.dropped()
    result = {"correct": judge.correct(readings),
              "attempted": len(dropped),
              "failed": sum(1 for d in dropped if d),
              "metrics": metric_values(bench, args.workload, run.record(),
                                       bool(args.trace)),
              "device": device_info(device, memory),
              "hits_dropped": sum(dropped)}
    if args.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in run.trace["device_ops"]],
            "idle_gaps": [list(kv) for kv in run.trace["idle_gaps"]]}
    result["checks"] = readings
    return result


def device_info(device, memory: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": memory}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    args = parse(argv)
    from . import judge, spec
    try:
        bench = spec.load_benchmark()
        cell = spec.workload(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"tpgbench: {e}", file=sys.stderr)
        return 2
    pin_caches(spec.ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"tpgbench: the cell needs {cell['chips']} CUDA card(s), "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(bench, args, torch.device("cuda", 0), t_start)
    found = banned_modules()
    if found:
        print("tpgbench: loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for line in judge.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
