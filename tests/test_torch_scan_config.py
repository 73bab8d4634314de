"""The port's scan backend (``ops/scan.py``, ``ops/hits.decode_dense``), the
WIBEth processor's "scan", ``run_model("scan")``, ``utils/config``,
``stream/simulation`` and ``entry()`` against the JAX package on the CPU.
Inputs are made by numpy from a seed; integer pipeline, so every
comparison is exact equality (tolerance 0): hits in canonical (end_tick,
channel) order, dense masks and records, dropped counts, carried state."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from fdreadoutlibs_tpu.models import run_model as jrun_model
from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig, patterns
from fdreadoutlibs_tpu.ops import hits as jhits
from fdreadoutlibs_tpu.ops import scan as jscan
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.reference import (process_window_reference,
                                             run_reference)
from fdreadoutlibs_tpu.stream import WIBEthFrameProcessor as JWIBEth
from fdreadoutlibs_tpu.stream import simulation as jsimulation
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu.utils import config as jconfig
from fdreadoutlibs_tpu_torch.entry import entry
from fdreadoutlibs_tpu_torch.models import run_model
from fdreadoutlibs_tpu_torch.ops import hits, scan, tpg
from fdreadoutlibs_tpu_torch.stream import (DAPHNEStreamFrameProcessor,
                                            TDEFrameProcessor,
                                            WIB2FrameProcessor,
                                            WIBEthFrameProcessor,
                                            WIBFrameProcessor, simulation)
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.utils import config
from tests.test_tpg_scan import random_stream

torch.set_num_threads(1)

CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120,
              peak_gated=True),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150,
              accumulator_limit=5),
    TPGConfig.from_raw("FIR", threshold=5),
    TPGConfig.from_raw("FIR", threshold=5, track_peaks=False),
]
IDS = ["SimpleThreshold", "AbsRS", "StandardRS", "Simple-gated",
       "AbsRS-acc5", "FIR", "FIR-nopeaks"]
# The float running sum is held to the numpy oracle only: the JAX scan's
# XLA:CPU float arithmetic rounds differently from numpy's (on
# random_stream(256, 32, seed=22), AbsRS threshold 150, one-tick windows:
# rs[20] at tick 145 is -10 against the oracle's -9), while the port, the
# oracle and the JAX Pallas kernel agree (ROADMAP.md §3).
RS_FLOAT = [TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150,
                      rs_float=True),
            TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=60,
                      rs_float=True)]


def _windows(adcs, cfg, window=64):
    """Both scans over consecutive windows carrying state: per window the
    JAX (closed, records) and the port's, then both final states."""
    T, C = adcs.shape
    seeded = seed_chanstate(init_chanstate(C), adcs[0],
                            cfg.rs_memory_factor_x10)
    jst = jscan.state_to_jnp(seeded)
    st = scan.state_to_torch(seeded)
    out = []
    for t0 in range(0, T, window):
        w = adcs[t0:t0 + window]
        jc, jr, jst = jscan.process_window_scan(jnp.asarray(w), jst, cfg)
        c, r, st = scan.process_window_scan(torch.from_numpy(w), st, cfg)
        out.append(((np.asarray(jc), {k: np.asarray(v)
                                      for k, v in jr.items()}), (c, r), t0))
    return out, jst, st


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_process_window_scan_matches_jax(cfg):
    adcs = random_stream(256, 32, seed=CONFIGS.index(cfg) + 17)
    out, jst, st = _windows(adcs, cfg)
    parts = []
    for (jc, jr), (c, r), t0 in out:
        assert c.dtype == torch.bool and c.shape == jc.shape
        np.testing.assert_array_equal(c.numpy(), jc)
        for f in scan.RECORD_FIELDS:
            np.testing.assert_array_equal(r[f].numpy(), jr[f], err_msg=f)
        got = hits.decode_dense(c, r, tick_offset=t0)
        np.testing.assert_array_equal(
            got, jhits.decode_dense(jc, jr, tick_offset=t0))
        parts.append(got)
    for k in scan.STATE_KEYS:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    # and the numpy oracle over the whole stream
    ref, _ = run_reference(adcs, cfg)
    assert len(ref) > 0
    np.testing.assert_array_equal(hits.concat_hits(parts), ref)


@pytest.mark.parametrize("cfg", RS_FLOAT, ids=["AbsRS", "StandardRS"])
def test_process_window_scan_rs_float_matches_oracle(cfg):
    adcs = random_stream(256, 32, seed=22)
    C = adcs.shape[1]
    st = seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10)
    tst = scan.state_to_torch(st)
    for t0 in range(0, 256, 64):
        w = adcs[t0:t0 + 64]
        want, st = process_window_reference(w, st, cfg, tick_offset=t0)
        c, r, tst = scan.process_window_scan(torch.from_numpy(w), tst, cfg)
        assert len(want) > 0 or t0
        np.testing.assert_array_equal(
            hits.decode_dense(c, r, tick_offset=t0), want)
        for k in scan.STATE_KEYS:
            np.testing.assert_array_equal(tst[k].numpy(), st[k], err_msg=k)


@pytest.mark.parametrize("max_hits", [3, 64, 1024])
@pytest.mark.parametrize("cfg", CONFIGS[:2] + CONFIGS[-1:],
                         ids=["SimpleThreshold", "AbsRS", "FIR-nopeaks"])
def test_compact_hits_device_matches_jax(cfg, max_hits):
    adcs = random_stream(128, 48, seed=5, n_signals=60)
    out, _, _ = _windows(adcs, cfg, window=128)
    (jc, jr), (c, r), _ = out[0]
    jh, jn, jd = jscan.compact_hits_device(jnp.asarray(jc), jr,
                                           max_hits=max_hits)
    h, n, d = scan.compact_hits_device(c, r, max_hits=max_hits)
    assert h.shape == (max_hits, 6) and h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert (int(n), int(d)) == (int(jn), int(jd))
    if max_hits == 3:
        assert int(d) > 0                  # the overflow is counted
    np.testing.assert_array_equal(scan.compact_to_numpy(h, n),
                                  jscan.compact_to_numpy(jh, jn))


@pytest.mark.parametrize("cfg", [CONFIGS[1], CONFIGS[6]],
                         ids=["AbsRS", "FIR-nopeaks"])
def test_run_model_scan_matches_jax(cfg):
    adcs = random_stream(300, 32, seed=9)
    got, st = run_model(adcs, cfg, "scan", device="cpu")
    want, wst = jrun_model(adcs, cfg, backend="scan")
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    for k in scan.STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(wst[k]),
                                      err_msg=k)


def _golden_frames(n_frames=4):
    frames, _ = patterns.pattern_frames(
        "golden", first_timestamp=10_000, crate_id=1, slot_id=2,
        stream_id=3, n_frames=n_frames, channel=7, offset=60)
    return frames


@pytest.mark.parametrize("algorithm,threshold",
                         [("SimpleThreshold", 499), ("AbsRS", 150)])
def test_wibeth_scan_processor_matches_jax(algorithm, threshold):
    rng = np.random.default_rng(4)
    frames = _golden_frames(6)
    from fdreadoutlibs_tpu.formats import wibeth as jwibeth
    adcs = jwibeth.get_adcs(frames).astype(np.int32)
    adcs += rng.integers(0, 40, size=adcs.shape, dtype=np.int32) + 800
    adcs[3, 10:20, 30] += 900
    jwibeth.set_adcs(frames, adcs.astype(np.uint16))
    conf = {"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
            "tpg_algorithm": algorithm, "tpg_threshold": threshold,
            "tp_timeout": 100_000, "tpg_backend": "scan"}
    port = WIBEthFrameProcessor(tp_sink=QueueSender(), device="cpu")
    ref = JWIBEth(tp_sink=JQueueSender())
    for p in (port, ref):
        p.conf(conf)
        p.start()
        for b in range(3):
            p.process(frames[2 * b:2 * b + 2].copy())
    assert port.backend == "scan"
    got = np.concatenate(port.tp_sink.drain())
    want = np.concatenate(ref.tp_sink.drain())
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    for k in scan.STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(port.current_state()[k]),
                                      np.asarray(ref.current_state()[k]),
                                      err_msg=k)


# ---- utils/config ---------------------------------------------------------

def test_config_dataclasses_match_jax():
    for cls, jcls in ((config.RawDataProcessorConf,
                       jconfig.RawDataProcessorConf),
                      (config.ReadoutModelConf, jconfig.ReadoutModelConf)):
        assert cls().as_dict() == jcls().as_dict()
    blob = {"rawdataprocessorconf": {"tpg_threshold": 42, "enable_tpg": True,
                                     "tpg_backend": "scan"},
            "readoutmodelconf": {"tpset_window_size": 5000}}
    got, want = config.load_config(blob), jconfig.load_config(blob)
    for key in blob:
        assert got[key].as_dict() == want[key].as_dict()


def test_load_config_file_and_unknown_key(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text(json.dumps({"rawdataprocessorconf": {"tpg_threshold": 7}}))
    assert config.load_config(p)["rawdataprocessorconf"].as_dict() == \
        jconfig.load_config(p)["rawdataprocessorconf"].as_dict()
    for load in (config.load_config, jconfig.load_config):
        with pytest.raises(KeyError):
            load({"rawdataprocessorconf": {"tppg_threshold": 1}})


@pytest.mark.parametrize("cls", [WIBEthFrameProcessor, WIB2FrameProcessor,
                                 WIBFrameProcessor,
                                 DAPHNEStreamFrameProcessor,
                                 TDEFrameProcessor],
                         ids=lambda c: c.__name__)
def test_every_processor_accepts_the_dataclass_dict(cls):
    conf = config.RawDataProcessorConf(enable_tpg=True, tpg_threshold=499,
                                       crate_id=1, slot_id=2,
                                       link_id=3).as_dict()
    proc = cls(device="cpu")
    proc.conf(conf)
    proc.start()
    assert proc.backend == "pallas"          # "auto": the kernel route
    if hasattr(proc, "tpg_cfg"):
        assert proc.tpg_cfg.threshold == 499


# ---- stream/simulation ----------------------------------------------------

def test_simulation_matches_jax():
    np.testing.assert_array_equal(simulation.unipolar_pulse(),
                                  jsimulation.unipolar_pulse())
    np.testing.assert_array_equal(simulation.bipolar_pulse(20, 3.0),
                                  jsimulation.bipolar_pulse(20, 3.0))
    for seed in (0, 3):
        got, truth = simulation.simulate_stream(512, 48, seed=seed)
        want, jtruth = jsimulation.simulate_stream(512, 48, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert truth == jtruth


# ---- entry() --------------------------------------------------------------

def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    jh, jn, jst = jax.jit(jfn)(*jargs)
    fn, args = entry(device="cpu")
    assert args[0].shape == (64, 28) and args[1].device.type == "cpu"
    h, n, st = fn(*args)
    assert int(n) == int(jn) == 1
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    got = tpg.unpack_state(st)
    for k in scan.STATE_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(jst[k]), err_msg=k)
    assert tpg.process_window.launches == 0   # the plain version, no kernel
