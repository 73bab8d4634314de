"""Device records of successive profiler captures in one process — the
measurement behind ``cli profile``'s retake (the JAX package's capture is
``jax.profiler``'s and has no counterpart of it).

It takes ``n`` ``utils.logging.device_trace`` captures, each of
``windows`` tpg windows on a ``channels`` x ``ticks`` plain feed (AbsRS on
K2 and FIR on K3 in turn, as ``cli profile`` launches them), and sorts the
captures by their trace: a kernel record for every kernel launch and a
copy record for every copy call ("whole"), some of them ("short") or none
("empty"). Between captures ``gap`` puts nothing ("none") or what ``cli
profile`` does before its capture ("cli": new data, its copy to the card,
one launch). CUPTI's teardown between captures follows
``TEARDOWN_CUPTI`` as the caller set it (``device_trace`` sets 0 when it
is unset).

``python -m fdreadoutlibs_tpu_torch.probes.trace_capture --n 100 --gap
cli`` on the card prints one JSON line; ``--device cpu`` runs the plain
version (no device record and no launch: every capture is "whole").
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..ops import TPGConfig, tpg
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..utils.logging import device_records, device_trace

GAPS = ("none", "cli")


def captures(n: int, gap: str = "none", device=None, channels: int = 2560,
             ticks: int = 8192, windows: int = 4, tc: int = 256,
             log=print) -> dict:
    """``n`` captures; each one short of device records is reported (one
    JSON line).  Returns the counts."""
    if gap not in GAPS:
        raise ValueError(f"gap {gap!r} is not one of {GAPS}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("trace_capture needs a CUDA card "
                               "(device='cpu' runs the plain version)")
        device = "cuda:0"
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)

    def feed():
        adcs = (900 + rng.normal(0, 30, size=(ticks, channels))).astype(
            np.int32)
        return adcs, torch.from_numpy(adcs).to(dev)

    adcs, x = feed()
    cfgs = [TPGConfig.from_raw("AbsRS", threshold=150),
            TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)]
    states = [tpg.pack_state(seed_chanstate(init_chanstate(channels),
                                            adcs[0], c.rs_memory_factor_x10),
                             channels, device=dev) for c in cfgs]

    chunk = tpg.auto_tc(ticks, cap=tc)

    def run(j, s):
        return tpg.process_window(x, s, cfgs[j], tc=chunk, k_slots=4,
                                  time_packed=False)

    for j in range(len(cfgs)):          # build and load outside the traces
        run(j, states[j])
    sync()
    counts = {"whole": 0, "short": 0, "empty": 0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            j = i % len(cfgs)
            if gap == "cli":
                _, x = feed()
                run(j, states[j])
                sync()
            d = os.path.join(td, str(i))
            with device_trace(d):
                s = states[j]
                for _ in range(windows):
                    _, _, s = run(j, s)
                sync()
            rec = device_records(d)
            whole = (rec["kernel"], rec["gpu_memcpy"]) == \
                (rec["launched"], rec["copied"])
            kind = "whole" if whole else \
                "empty" if rec["kernel"] == rec["gpu_memcpy"] == 0 else "short"
            counts[kind] += 1
            if not whole:
                log(json.dumps({"capture": i, **rec}))
    return {"captures": n, **counts, "gap": gap,
            "teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
            "device": str(dev),
            "s_per_capture": (time.perf_counter() - t0) / max(n, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--gap", choices=GAPS, default="cli")
    ap.add_argument("--channels", type=int, default=2560)
    ap.add_argument("--ticks", type=int, default=8192)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain version in the kernel's "
                    "place")
    args = ap.parse_args(argv)
    print(json.dumps(captures(args.n, args.gap, args.device, args.channels,
                              args.ticks, args.windows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
