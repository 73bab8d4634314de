"""The port's fuzzers (``probes/fuzz_sweep.py``, ``fuzz_frames.py``,
``fuzz_tp_path.py``) against the JAX package's scripts and tests
(``scripts/fuzz_*.py`` imported by path, ``tests/test_fuzz_semantics.py``),
small and on the CPU (the plain version in the kernel's place); and the
callers of ``kernel_knobs`` handing its geometry to the kernel."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops.chanstate import init_chanstate as jinit
from fdreadoutlibs_tpu.ops.chanstate import seed_chanstate as jseed
from fdreadoutlibs_tpu.ops.hits import concat_hits as jconcat
from fdreadoutlibs_tpu.ops.hits import decode_dense as jdecode
from fdreadoutlibs_tpu.ops.scan import process_window_scan, state_to_jnp
from fdreadoutlibs_tpu_torch.probes import fuzz_frames, fuzz_sweep, \
    fuzz_tp_path
from fdreadoutlibs_tpu_torch.utils import tuning
from fdreadoutlibs_tpu_torch.utils.tuning import Geometry
from test_fuzz_semantics import _case as jcase

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import fuzz_frames as jfuzz_frames  # noqa: E402
import fuzz_tp_path as jfuzz_tp_path  # noqa: E402

torch.set_num_threads(1)

SEEDS = [101, 404, 707]         # test_fuzz_semantics' seeds; 404 draws FIR


@pytest.mark.parametrize("seed", [101, 202, 404, 707, 1010])
def test_case_generator_is_the_jax_tests(seed):
    """``fuzz_sweep.case`` is ``test_fuzz_semantics._case``: the same
    configuration, memory factors, samples and batch bounds."""
    cfg, rmf, adcs, bounds = fuzz_sweep.case(seed)
    jcfg, jrmf, jadcs, jbounds = jcase(seed)
    assert cfg.algorithm.value == jcfg.algorithm.value
    for f in ("threshold", "accumulator_limit", "rs_scale_factor_x10",
              "track_peaks"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    np.testing.assert_array_equal(rmf, jrmf)
    np.testing.assert_array_equal(adcs, jadcs)
    assert bounds == jbounds


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_sweep_matches_the_jax_scan(seed):
    """On a seed of ``test_fuzz_semantics.py`` the port's scan and the
    kernel's plain version (its batches, the time2 feed cut at even ticks
    and, for FIR, the lifted two-pass schedule) give the JAX scan's hits
    and state; ``run_case`` holds all of them to the oracle."""
    cfg, rmf, adcs, bounds = jcase(seed)
    state = state_to_jnp(jseed(jinit(fuzz_sweep.C), adcs[0], rmf))
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        closed, records, state = process_window_scan(adcs[a:b], state, cfg)
        parts.append(jdecode(closed, records, tick_offset=a))
    want = jconcat(parts)
    pcfg, *_ = fuzz_sweep.case(seed)
    h_scan, st_scan = fuzz_sweep.scan_run(pcfg, rmf, adcs, bounds)
    np.testing.assert_array_equal(h_scan, want)
    runs = [(bounds, False, 0), (fuzz_sweep.even_bounds(bounds), True, 0)]
    if pcfg.algorithm.value == "FIR":
        runs.append((bounds, False, 2))
    for b, time2, tp in runs:
        h, dropped, st, launches = fuzz_sweep.kernel_run(
            pcfg, rmf, adcs, b, "cpu", time2, tp)
        assert dropped == 0 and launches == 0
        np.testing.assert_array_equal(h, want, err_msg=f"{time2} {tp}")
        for k in ("pedestals", "accum", "hit_charge", "hit_tover"):
            np.testing.assert_array_equal(st[k], np.asarray(state[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(st_scan[k], np.asarray(state[k]),
                                          err_msg=k)
    res = fuzz_sweep.run_case(seed, "cpu", kernel=True)
    assert res["runs"] == len(runs)


def test_fuzz_sweep_summary_and_refusal():
    """``sweep`` counts its cases and failures; without a card it raises
    unless the CPU is asked for."""
    res = fuzz_sweep.sweep(4, 20_000, "cpu", kernel_every=2)
    assert res["failures"] == 0 and res["kernel_cases"] == 2
    assert sum(res["by_alg"].values()) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fuzz_sweep.sweep(1, 0)


JAX_RIGS = {r.name: r for r in (
    jfuzz_frames.WIBEthRig(), jfuzz_frames.WIB2Rig(),
    jfuzz_frames.ProtoWIBRig(), jfuzz_frames.DAPHNEStreamRig(),
    jfuzz_frames.DAPHNERig(), jfuzz_frames.TDERig(), jfuzz_frames.SSPRig())}
PORT_RIGS = [cls() for cls in fuzz_frames.RIGS]


@pytest.mark.parametrize("rig", [r.name for r in PORT_RIGS])
def test_fuzz_frames_rig_matches_jax(rig):
    """One seed's corrupt payloads (the same bytes and corruptions from
    both rigs) through the JAX processor and the port's, on the "scan"
    backend ("reference" for the formats without a TPG): the same TPs,
    counters and FrameErrorRegistry entries.  The port's own case (its
    "pallas" backend on the CPU against "reference") passes."""
    prig = next(r for r in PORT_RIGS if r.name == rig)
    jrig = JAX_RIGS[rig]
    seed = 11 + [r.name for r in PORT_RIGS].index(rig)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    jp, pp = jrig.build(r1, 6), prig.build(r2, 6)
    jkinds, jdet = jfuzz_frames.corrupt(jrig, jp, r1)
    pkinds, pdet = fuzz_frames.corrupt(prig, pp, r2)
    assert pkinds == jkinds and pdet == jdet
    np.testing.assert_array_equal(pp.view(np.uint8), jp.view(np.uint8))
    backend = "scan" if prig.dual_backend else "reference"
    bounds = [0, 2, 6]
    jproc, jtps = jfuzz_frames.drive(jrig, jp, bounds, backend)
    pproc, ptps = fuzz_frames.drive(prig, pp, bounds, backend, "cpu")
    assert (jtps is None) == (ptps is None)
    if jtps is not None:
        np.testing.assert_array_equal(ptps, jtps)
    assert dict(pproc.metrics._counters) == dict(jproc.metrics._counters)
    jreg, preg = jproc.error_registry, pproc.error_registry
    assert dict(preg._counts) == dict(jreg._counts)
    for name in jreg._counts:
        assert [(e.start, e.end) for e in preg.recent(name)] == \
            [(e.start, e.end) for e in jreg.recent(name)]
    res = fuzz_frames.run_case(PORT_RIGS, seed, "cpu", rig=rig)
    assert res["error"] is None, res


def test_tp_mismatch_allows_only_the_kernels_contract():
    """Check 3's comparison: equal streams pass; a stream short of exactly
    the counted drops, every TP of it in the reference, passes (with no
    count, any part of the reference); a charge above 32767 compares as
    the 16-bit record holds it; anything else fails."""
    from fdreadoutlibs_tpu_torch.formats.trigprim import make_tps
    ref = make_tps(4)
    ref["time_start"] = [10, 20, 30, 40]
    ref["adc_integral"] = [100, 32784, 5, 6]
    pallas = ref.copy()
    pallas["adc_integral"][1] = np.uint32((32784 - 65536) & 0xFFFFFFFF)
    assert fuzz_frames.tp_mismatch(pallas, ref, 0) is None
    assert fuzz_frames.tp_mismatch(pallas[[0, 2, 3]], ref, 1) is None
    assert fuzz_frames.tp_mismatch(pallas[[0, 2]], ref, 1) is not None
    bad = ref.copy()
    bad["adc_integral"][0] = 101
    assert fuzz_frames.tp_mismatch(bad, ref, 0) is not None
    assert fuzz_frames.tp_mismatch(bad[[0, 2, 3]], ref, 1) is not None
    assert fuzz_frames.tp_mismatch(None, None, 0) is None
    # a processor that counts no drop (TDE): a part of the reference
    assert fuzz_frames.tp_mismatch(pallas[[1, 3]], ref, None) is None
    assert fuzz_frames.tp_mismatch(bad[[0, 3]], ref, None) is not None
    assert fuzz_frames.tp_mismatch(np.concatenate([ref, ref[:1]]), ref,
                                   None) is not None


def test_fuzz_frames_sweep_on_cpu():
    """A few drawn cases and one seed a rig: no failure, every rig seen,
    errors counted; without a card it raises unless asked for the CPU."""
    res = fuzz_frames.sweep(3, 50_000, "cpu", per_rig=1, log=print)
    assert res["failures"] == 0
    assert {r.name for r in PORT_RIGS} <= set(res["by_rig"])
    assert res["errors_seen"] > 0 and res["launches"] == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fuzz_frames.sweep(1, 0)


@pytest.mark.parametrize("seed", [56000, 56001, 56007])
def test_fuzz_tp_path_matches_jax(seed):
    """The differential case on the port's handler and buffers gives the
    JAX script's record on the JAX package's (accepted, inserted, TPSets,
    no failure)."""
    from fdreadoutlibs_tpu_torch import native
    got = fuzz_tp_path.run_case(seed, native.available())
    want = jfuzz_tp_path.run_case(seed, native.available())
    assert got == want
    assert got["failures"] == []


def test_fuzz_tp_path_smoke():
    res = fuzz_tp_path.sweep(5, 56100, hammer=1, log=print)
    assert res["failures"] == 0 and res["hammer_failures"] == 0


# ---- the callers hand kernel_knobs' geometry to the kernel -----------------

@pytest.fixture
def tuned_geometry(tmp_path, monkeypatch):
    """A tuned file naming a non-shipped geometry for AbsRS and FIR, and the
    geometries that reach ``tpg.process_window``'s plain path."""
    from fdreadoutlibs_tpu_torch.ops import tpg
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"AbsRS": {"group": 8, "stages": 2},
                                "FIR": {"stage_ticks": 64}}))
    monkeypatch.setenv("FDREADOUT_TUNED", str(path))
    tuning._cache.clear()
    seen = []
    orig = tpg._check_geometry

    def record(geometry, *args):
        seen.append(geometry)
        return orig(geometry, *args)
    monkeypatch.setattr(tpg, "_check_geometry", record)
    yield seen
    tuning._cache.clear()


def test_callers_pass_the_tuned_geometry(tuned_geometry):
    """``StreamingIngest``, the APA app, the scheduler, the link-axis
    pipeline and ``run_model`` launch at the tuned geometry of their
    family; the hits are those of the shipped geometry (none changes a
    hit)."""
    from fdreadoutlibs_tpu_torch.apps.apa_readout import (APAReadoutApp,
                                                          make_batch)
    from fdreadoutlibs_tpu_torch.apps.scheduler import MultiAPAScheduler
    from fdreadoutlibs_tpu_torch.formats import wibeth
    from fdreadoutlibs_tpu_torch.models import run_model
    from fdreadoutlibs_tpu_torch.ops import TPGConfig
    from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest
    from fdreadoutlibs_tpu_torch.parallel import APAPipeline, make_link_mesh
    from fdreadoutlibs_tpu_torch.testing import fir_stream
    rs = Geometry(8, 32, 2)
    abs_rs = TPGConfig.from_raw("AbsRS", threshold=150)
    frames = make_batch(np.random.default_rng(1), 2, 2, 0, 0x1000000)[0]
    ing = StreamingIngest(abs_rs, 2, tc=64, device="cpu", time2=True)
    assert ing.geometry == rs
    ing.submit(frames)
    ing.flush()
    app = APAReadoutApp(n_links=2, algorithm="AbsRS", threshold=150,
                        device="cpu", fused_unpack=True)
    app.process_batch(frames)
    sched = MultiAPAScheduler(abs_rs, n_apas=1, n_links=2, device="cpu")
    sched.submit(0, frames)
    sched.flush()
    words = wibeth.frames_bytes_to_u32(
        frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(2, 128, 28)
    APAPipeline(2, abs_rs, mesh=make_link_mesh(1, device="cpu"),
                backend="pallas").process(words)
    assert tuned_geometry and all(g == rs for g in tuned_geometry)
    tuned_geometry.clear()
    fir = TPGConfig.from_raw("FIR", threshold=5)
    run_model(fir_stream(128, 16, 64, 2, seed=3), fir, "pallas",
              device="cpu")
    assert tuned_geometry and all(g == Geometry(16, 64, 4)
                                  for g in tuned_geometry)
