"""The readings that the comparison's limits are set from, for one cell,
in one process: on each seed, a set-up and a short window of the cell at
its own size and load, then the program's readings (the lower ones) and,
on the first ``--control-seeds`` seeds, the control's (the upper ones):
the plain reference put in the program's place on samples cut to 12 bits
(the two lowest of the 14 bits dropped), the step down in precision a
packed feed would tempt.

    python3 -m tpgbench.control --workload hd_apa_wibeth.nominal \\
        --seeds 11,12,13 --seconds 3

One JSON line a seed; exit 1 if a program reading passes its limit or a
control reading does not.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

CONTROL_MASK = ~3


def readings(bench: dict, cell: str, seed: int, seconds: float, device,
             control: bool, overrides: dict | None = None) -> dict:
    from .harness import Run
    run = Run(bench, cell, seed, device, overrides)
    run.warm()
    run.window(seconds)
    run.system.finish()
    out = {"seed": seed, "program": run.system.judge()}
    if control:
        out["control"] = run.system.judge(
            run.system.control_outputs(CONTROL_MASK))
    return out


def failed(r: dict) -> bool:
    """A program reading past its limit, or a control that passes."""
    from . import judge
    bad = not judge.correct(r["program"])
    if "control" in r:
        bad |= judge.correct(r["control"])
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tpgbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    from . import harness, spec
    harness.pin_caches(spec.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("tpgbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    bad = False
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(bench, args.workload, seed, args.seconds,
                     torch.device("cuda", 0), i < args.control_seeds)
        bad |= failed(r)
        print(json.dumps(r), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
