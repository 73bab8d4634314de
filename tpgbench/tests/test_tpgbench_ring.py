"""The source never rewrites a slab that the app's zero-copy raw
retention still holds."""

import numpy as np
import torch

from tpgbench import spec
from tpgbench.systems import apa_app
from tpgbench.generators.wibeth_slabs import Source

from conftest import CUT


def retained(app):
    for handler in app.readout:
        for _keys, rows in handler.buffer._segs:
            yield rows


def test_ring_outlives_the_retention():
    bench = spec.load_benchmark()
    cfg = dict(spec.configuration(bench, "hd_apa_wibeth"), **{
        k: v for k, v in CUT.items() if k != "frames_per_batch"})
    traffic = dict(spec.traffic("nominal"),
                   frames_per_batch=CUT["frames_per_batch"])
    ring = apa_app.min_ring(cfg, traffic)
    src = Source(cfg, traffic, 1, torch.device("cpu"), 1, ring)
    drv = apa_app.System(cfg, traffic, src, torch.device("cpu"))
    held = 0
    for b in range(3 * ring):
        nxt = src.slab(0, b)
        assert not any(np.shares_memory(nxt, rows)
                       for rows in retained(drv.app))
        drv.step()
        held = max(held, sum(
            any(np.shares_memory(src.slab(0, k), rows)
                for rows in retained(drv.app)) for k in range(ring)))
    # the retention reaches back over half its capacity (cleanup trims to
    # it after each insert)
    assert held == cfg["raw_capacity_frames"] // (2 * CUT["frames_per_batch"])
