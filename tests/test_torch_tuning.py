"""The port's knob tuner and its consumer (``utils/tuning.py``,
``probes/autotune.py``) against the JAX package's (``fdreadoutlibs_tpu/
utils/tuning.py``, ``scripts/autotune.py`` loaded by path), and the
pipeline's geometry (``group``, ``stage_ticks``, ``stages``) built for the
host (``tests/torch_host_lib.py``) at two non-shipped geometries against
the plain version, with a ragged last stage.  Integers compare bit for
bit."""

import ctypes
import importlib.util
import json
import logging
import pathlib

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm as JAlgorithm
from fdreadoutlibs_tpu.ops import TPGConfig as JTPGConfig
from fdreadoutlibs_tpu.utils import tuning as jtuning
from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, _build,
                                         init_chanstate, seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.probes import autotune
from fdreadoutlibs_tpu_torch.testing import fir_stream, tpg_stream
from fdreadoutlibs_tpu_torch.utils import tuning
from fdreadoutlibs_tpu_torch.utils.tuning import SHIPPED_GEOMETRY, Geometry
from torch_host_lib import host_library

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_autotune():
    spec = importlib.util.spec_from_file_location(
        "jax_autotune", ROOT / "scripts" / "autotune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jautotune = _load_jax_autotune()


@pytest.fixture(autouse=True)
def _clear_cache(monkeypatch):
    tuning._cache.clear()
    jtuning._cache.clear()
    monkeypatch.delenv("FDREADOUT_TUNED", raising=False)
    yield
    tuning._cache.clear()
    jtuning._cache.clear()


def _write(tmp_path, data) -> str:
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps(data))
    return str(path)


# ---- the consumer: kernel_knobs ---------------------------------------------

TUNED_FILES = {
    "shipped": None,
    "tc": {"AbsRS": {"tc": 512}, "FIR": {"tc": 128}},
    "k": {"AbsRS": {"k": 4}, "SimpleThreshold": {"k": 2}},
    "twopass": {"FIR": {"twopass": 2}},
    "twopass-above-2": {"FIR": {"twopass": 7}},
    "sub-unroll": {"AbsRS": {"sub": 8, "unroll": 16}, "FIR": {"sub": 0}},
    "geometry": {"AbsRS": {"group": 8, "stage_ticks": 64, "stages": 2}},
    "malformed": {"AbsRS": {"tc": "x", "k": 0, "twopass": -1, "group": True,
                            "stage_ticks": 1.5, "stages": None},
                  "FIR": {"tc": 0, "k": [2], "twopass": "1"}},
    "other-family": {"StandardRS": {"tc": 64, "k": 3, "twopass": 2}},
    "not-a-dict": {"AbsRS": [256, 2], "FIR": 3},
    "autotune-entry": {"AbsRS": {"tc": 512, "k": 2, "group": 16,
                                 "stage_ticks": 64, "stages": 4,
                                 "gsps": 1.0, "confirmed": True,
                                 "confirm": [{"tc": 512, "ms": 0.5}]}},
}


@pytest.mark.parametrize("explicit_tc", [None, 96], ids=["file", "arg"])
@pytest.mark.parametrize("name", list(TUNED_FILES))
def test_kernel_knobs_match_jax(name, explicit_tc, tmp_path, monkeypatch):
    """Every family's tc, k_slots and fir_twopass equal the JAX package's
    for the same tuned file (an explicit tc first, then the file's field,
    then the shipped value), and the TPU's sub and unroll leave the
    geometry shipped."""
    tuned = TUNED_FILES[name]
    if tuned is not None:
        monkeypatch.setenv("FDREADOUT_TUNED", _write(tmp_path, tuned))
    for alg in Algorithm:
        cfg = TPGConfig(algorithm=alg, threshold=5)
        jcfg = JTPGConfig(algorithm=JAlgorithm(alg.value), threshold=5)
        want = jtuning.kernel_knobs(jcfg, 2560, tc=explicit_tc)
        got = tuning.kernel_knobs(cfg, explicit_tc)
        assert (got["tc"], got["k_slots"]) == (want["tc"], want["k_slots"])
        # the JAX kernel takes any twopass >= 2 as the lifted schedule,
        # which the port names 2
        assert got["fir_twopass"] == min(want["fir_twopass"], 2), alg
        if name not in ("geometry", "autotune-entry") or \
                alg != Algorithm.ABS_RS:
            assert got["geometry"] == SHIPPED_GEOMETRY, alg
    if name == "geometry":
        got = tuning.kernel_knobs(TPGConfig.from_raw("AbsRS", threshold=150))
        assert got["geometry"] == Geometry(8, 64, 2)
        assert (got["geometry"].group, got["geometry"].stage_ticks,
                got["geometry"].stages) == (8, 64, 2)


# (tuned AbsRS / FIR entry, the AbsRS geometry, the FIR geometry); FIR
# keeps peak tracking, so under twopass 2 K5 takes 6 slabs a stage
FALLBACKS = {
    "group-not-8": ({"group": 12, "stages": 2}, (16, 32, 2), (16, 32, 2)),
    "group-8-stages-8": ({"group": 8, "stages": 8}, (8, 32, 8), (8, 32, 8)),
    "stage-not-groups": ({"stage_ticks": 40, "stages": 2}, (16, 32, 2),
                         (16, 32, 2)),
    "stage-not-group-32": ({"group": 32, "stage_ticks": 48}, (32, 32, 4),
                           (32, 32, 4)),
    "group-64": ({"group": 64}, (16, 32, 4), (16, 32, 4)),
    "one-stage": ({"stages": 1, "group": 8}, (8, 32, 4), (8, 32, 4)),
    "ring-over-shared": ({"stages": 8, "stage_ticks": 64}, (16, 64, 4),
                         (16, 64, 4)),
    "k5-ring-over-shared": ({"stages": 6, "stage_ticks": 64, "twopass": 2},
                            (16, 64, 6), (16, 64, 4)),
    "ring-and-group": ({"group": 64, "stage_ticks": 512, "stages": 8},
                       (16, 32, 4), (16, 32, 4)),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_geometry_rules_fall_back_field_by_field(name, tmp_path, caplog):
    """A tuned geometry that breaks a rule (a group of whole FIR-ring
    turns, a stage of whole groups, a ring of 2 or more stages, the ring's
    shared memory within kMaxSharedBytes for the family's encodings and
    schedule) goes back to the shipped value field by field, with a
    warning; what is left is a geometry that breaks no rule."""
    entry, want_rs, want_fir = FALLBACKS[name]
    path = _write(tmp_path, {"AbsRS": entry, "FIR": entry})
    for alg, want in ((Algorithm.ABS_RS, want_rs), (Algorithm.FIR, want_fir)):
        cfg = TPGConfig(algorithm=alg, threshold=5)
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            got = tuning.kernel_knobs(cfg, path=path)["geometry"]
        assert got == Geometry(*want), alg
        twopass = entry.get("twopass", 0) if alg == Algorithm.FIR else 0
        assert tuning.geometry_problem(got, alg, None, cfg.track_peaks,
                                       min(twopass, 2)) is None
        changed = any(entry.get(f, v) != g for f, v, g in
                      zip(Geometry._fields, SHIPPED_GEOMETRY, got))
        assert ("ignoring tuned" in caplog.text) == changed, alg


def test_shared_memory_rule_counts_every_encoding():
    """The ring's rule holds for every encoding a family runs: a ring that
    fits the time2 feed but not the slab unpack's extra slab breaks it."""
    g = Geometry(16, 64, 8)
    assert tuning.geometry_problem(g, Algorithm.ABS_RS, "time2") is None
    assert "shared memory" in tuning.geometry_problem(g, Algorithm.ABS_RS,
                                                      "slab14")
    assert "shared memory" in tuning.geometry_problem(g, Algorithm.ABS_RS)


# ---- the producer's decision: the twice-confirmed rule ----------------------

class _Args:
    confirm = 2
    confirm_trials = 2
    channels = 2560
    ticks = 8192
    windows = 4


# shipped AbsRS: tc 256 in both tuners; the challenger takes tc 512
_JAX_OK = [{"sub": 0, "tc": 512, "unroll": 32, "k": 1, "ms": 0.9,
            "gsps": 1.0}]
CONFIRM_CASES = {
    "faster-both-passes": ({512: (0.8, [0.8, 0.8]), 256: (1.0, [1.0, 1.0])},
                           512),
    "single-pass-win": ({512: (0.85, [0.7, 1.0]), 256: (1.0, [1.0, 1.0])},
                        512),
    "within-margin": ({512: (0.99, [0.99, 0.99]), 256: (1.0, [1.0, 1.0])},
                      512),
    "winner-is-shipped": ({256: (1.0, [1.0, 1.0])}, 256),
    "shipped-unmeasurable": ({512: (0.8, [0.8, 0.8]),
                              256: (float("nan"), [float("nan")] * 2)}, 512),
}


def _stub(ms_by_tc):
    def fake(cands, passes=1):
        return [dict(c) | {"ms": ms_by_tc[c["tc"]][0], "gsps": 1.0,
                           "ms_passes": list(ms_by_tc[c["tc"]][1])}
                for c in cands]
    return fake


@pytest.mark.parametrize("name", list(CONFIRM_CASES))
def test_confirm_rule_matches_jax(name, monkeypatch):
    """The five stubbed cases of ``tests/test_autotune_confirm.py``: the
    port's ``confirm_stage`` takes the JAX tuner's decision (confirmed or
    not, the tc it keeps, the sweep winner beside an unmeasurable shipped
    arm), and an unconfirmed entry keeps the shipped geometry."""
    ms_by_tc, sweep_tc = CONFIRM_CASES[name]
    jax_ok = [dict(_JAX_OK[0], tc=sweep_tc)]
    monkeypatch.setattr(
        jautotune, "measure_candidates",
        lambda alg, cands, *a, passes=1, **kw: _stub(ms_by_tc)(cands,
                                                               passes))
    want = jautotune._confirm_stage("AbsRS", jax_ok, dict(jax_ok[0]),
                                    _Args())
    ok = [{"tc": sweep_tc, "k": 1, **SHIPPED_GEOMETRY._asdict(), "ms": 0.9,
           "gsps": 1.0}]
    got = autotune.confirm_stage("AbsRS", ok, dict(ok[0]), _stub(ms_by_tc),
                                 2, log=lambda s: None)
    assert got["confirmed"] is want["confirmed"]
    assert got["tc"] == want["tc"]
    assert ("sweep_winner" in got) == ("sweep_winner" in want)
    if "sweep_winner" in want:
        assert got["sweep_winner"]["tc"] == want["sweep_winner"]["tc"]
    if not got["confirmed"]:
        assert {k: got[k] for k in Geometry._fields} == \
            SHIPPED_GEOMETRY._asdict()


def test_quick_space_spans_shipped():
    """``--quick`` holds every family's shipped point (tc, k, the shipped
    geometry, FIR's fused tick) and at most one other geometry, and sweeps
    the JAX tuner's quick tc and k; the full space is the JAX tuner's tc
    and k at seven geometries."""
    for quick in (True, False):
        jtc = {(c["tc"], c["k"])
               for c in jautotune.candidate_space(quick)}
        for alg in autotune.ALGS:
            space = autotune.space(alg, quick)
            assert {(c["tc"], c["k"]) for c in space} == jtc
            ship = autotune.shipped_knobs(alg)
            assert ship in space, alg
            geoms = {autotune.geometry_of(c) for c in space}
            assert SHIPPED_GEOMETRY in geoms
            assert len(geoms) == (2 if quick else 7)
            for g in geoms:
                assert sum(a != b for a, b in zip(g, SHIPPED_GEOMETRY)) <= 1
            if alg == "FIR":
                assert {c["twopass"] for c in space} == {0, 1, 2}


def test_skips_before_any_build():
    """A candidate that breaks a rule is skipped with its reason, before
    any library is asked for."""
    assert autotune.skip_reason("AbsRS", {"tc": 256, "k": 1}, 8192) is None
    assert "divide" in autotune.skip_reason("AbsRS", {"tc": 384, "k": 1},
                                            8192)
    why = autotune.skip_reason("FIR", {"tc": 256, "k": 1, "twopass": 2,
                                       "group": 16, "stage_ticks": 64,
                                       "stages": 8}, 8192)
    assert "shared memory" in why


def test_tuner_on_cpu_writes_a_file_both_packages_read(tmp_path, monkeypatch):
    """The tuner end to end on the plain versions (32 channels x 512 ticks,
    quick, confirm 2): every candidate equals the full-capacity plain run
    re-chunked to its tc and k (``reslot``) and the shipped geometry's
    outputs; the written file, read back, gives each family its entry's
    knobs in the port and tc and k in the JAX package."""
    logs = []
    res = autotune.run("cpu", algs=["AbsRS", "FIR"], quick=True, C=32,
                       T=512, windows=1, trials=1, confirm=2,
                       confirm_trials=1, log=logs.append)
    assert set(res["tuned"]) == {"AbsRS", "FIR"}
    assert len(res["sweep"]["AbsRS"]) == 8 and len(res["sweep"]["FIR"]) == 24
    path = _write(tmp_path, res["tuned"])
    monkeypatch.setenv("FDREADOUT_TUNED", path)
    for alg, entry in res["tuned"].items():
        cfg = TPGConfig.from_raw(alg, threshold=5)
        got = tuning.kernel_knobs(cfg)
        assert (got["tc"], got["k_slots"]) == (entry["tc"], entry["k"])
        assert tuple(got["geometry"]) == tuple(
            entry[f] for f in Geometry._fields)
        assert got["fir_twopass"] == entry.get("twopass", 0)
        want = jtuning.kernel_knobs(JTPGConfig.from_raw(alg, threshold=5),
                                    2560)
        assert (want["tc"], want["k_slots"], want["fir_twopass"]) == \
            (entry["tc"], entry["k"], entry.get("twopass", 0))
    assert any("confirming FIR" in line for line in logs)


def test_reslot_equals_a_run_at_that_chunk():
    """The full-capacity plain run re-chunked equals the plain version run
    at the coarser chunk and fewer slots, drops included."""
    cfg = TPGConfig.from_raw("AbsRS", threshold=40)
    adcs, rmf = tpg_stream(512, 32, 64, 2, seed=3)
    state = tpg.pack_state(seed_chanstate(init_chanstate(32), adcs[0], rmf),
                           32)
    feed = torch.from_numpy(adcs)
    full = tpg.process_window_plain(feed, state, cfg, 64, 33,
                                    time_packed=False)
    for tc, k in ((128, 1), (256, 2), (512, 3)):
        want = tpg.process_window_plain(feed, state, cfg, tc, k,
                                        time_packed=False)
        got = autotune.reslot(full[0], full[1], 64, tc, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[1].max()) > k          # drops exercised


# ---- the geometry at build time ---------------------------------------------

def test_shipped_geometry_keys_as_before():
    """No define for the shipped geometry: its library is keyed by the
    sources and the flags alone, as before defines existed; another
    geometry is another file, keyed on its defines."""
    flags = _build.NVCC_FLAGS + _build.LINK_FLAGS
    shipped = _build.keyed_path("tpg", _build.sources("tpg"), flags)
    assert tpg.geometry_defines() == tpg.geometry_defines(
        SHIPPED_GEOMETRY) == ()
    assert _build.library_path("tpg") == shipped
    assert _build.library_path("tpg", tpg.geometry_defines(
        SHIPPED_GEOMETRY)) == shipped
    other = tpg.geometry_defines(Geometry(8, 32, 4))
    assert other == (("TPG_GROUP", 8),)
    assert _build.library_path("tpg", other) != shipped
    assert _build.log_key("tpg") == "tpg"
    assert _build.log_key("tpg", other) == "tpg -DTPG_GROUP=8"


def test_geometry_rules_on_the_plain_path():
    """The plain version checks what a build and launch would refuse and
    otherwise ignores the geometry: the outputs are the same."""
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    adcs, rmf = tpg_stream(128, 32, 64, 2, seed=1)
    state = tpg.pack_state(seed_chanstate(init_chanstate(32), adcs[0], rmf),
                           32)
    feed = torch.from_numpy(adcs)
    want = tpg.process_window(feed, state, cfg, 64, 2, time_packed=False)
    got = tpg.process_window(feed, state, cfg, 64, 2, time_packed=False,
                             geometry=Geometry(8, 64, 2))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in ((12, 32, 4), (16, 40, 4), (16, 32, 1)):
        with pytest.raises(ValueError, match="geometry"):
            tpg.process_window(feed, state, cfg, 64, 2, time_packed=False,
                               geometry=Geometry(*bad))


# The two non-shipped geometries built for the host: a ring of 2 stages of
# 64 ticks, and groups of 8 ticks
GEOMETRIES = {"stages2-ticks64": Geometry(16, 64, 2),
              "group8": Geometry(8, 32, 4)}
C, TC, K, W = 64, 100, 2, 200     # tc 100: a ragged last stage and group


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def geometry_lib(request):
    g = GEOMETRIES[request.param]
    return g, host_library("tpg", tpg.geometry_defines(g))


def _host_fn(lib, twopass: int):
    fn = lib.tpg_fir2_launch if twopass else lib.tpg_launch
    fn.argtypes = tpg._FIR2_ARGTYPES if twopass else tpg._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# (family config, time2 feed, fir_twopass)
HOST_CASES = {
    "AbsRS-plain": (TPGConfig.from_raw("AbsRS", threshold=150), False, 0),
    "SimpleThreshold-time2": (TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                        threshold=120), True, 0),
    "StandardRS-time2": (TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                   threshold=150), True, 0),
    "FIR-K3-plain": (TPGConfig.from_raw("FIR", threshold=5), False, 0),
    "FIR-K5-time2-1": (TPGConfig.from_raw("FIR", threshold=5,
                                          track_peaks=False), True, 1),
    "FIR-K5-plain-2": (TPGConfig.from_raw("FIR", threshold=5), False, 2),
}


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_kernel_at_geometry_matches_plain(geometry_lib, name):
    """The host-built pipeline at a non-shipped geometry over two windows
    of 200 ticks carrying state, in chunks of 100 ticks (a stage of 64
    and a ragged one of 36; or three of 32 and a ragged one of 4, less
    than a group of 8): slots, nclose and state equal the plain version
    bit for bit (the threshold mode, K3 and K5), and the library's own
    ``tpg_shared_bytes`` counts the ring as ``utils/tuning.py`` does."""
    g, lib = geometry_lib
    cfg, time2, twopass = HOST_CASES[name]
    fir = cfg.algorithm == Algorithm.FIR
    if fir:
        adcs, rmf = fir_stream(2 * W, C, TC, K, seed=7), 0
    else:
        adcs, rmf = tpg_stream(2 * W, C, TC, K, seed=7)
    adcs[W - 4:W, 2] += 2000
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C)
    plain_state = state
    fn = _host_fn(lib, twopass)
    closes = 0
    for w in range(2):
        win = adcs[w * W:(w + 1) * W]
        feed = torch.from_numpy(np.ascontiguousarray(
            (win[0::2] & 0xFFFF) | (win[1::2] << 16) if time2 else win))
        slots, nclose, state = tpg._launch(
            fn, feed, state, cfg, TC, K, time2, None, 0, None, twopass,
            lib=lib)
        want = tpg.process_window(feed, plain_state, cfg, TC, K,
                                  time_packed=time2, fir_twopass=twopass,
                                  geometry=g)
        plain_state = want[2]
        for what, got, exp in zip(("slots", "nclose", "state"),
                                  (slots, nclose, state), want):
            assert torch.equal(got, exp), (name, w, what)
        closes = max(closes, int(nclose.max()))
    assert closes > K                       # drops exercised
    enc = tpg._TIME2 if time2 else tpg._PLAIN
    need, most = tpg.carry_shared_bytes(cfg, TC, 1, enc, lib=lib)
    assert most == tuning.MAX_SHARED_BYTES
    assert need == tuning.shared_bytes(g, cfg.algorithm,
                                       "time2" if time2 else "plain",
                                       cfg.track_peaks)
