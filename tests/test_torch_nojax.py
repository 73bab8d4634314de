"""The port runs with jax and the JAX package unimportable (the machine
with the card has no jax, and the port carries its own copy of every host
module it uses), and refuses CUDA work without a card instead of falling
back."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

def blocked(name):
    return (name.split(".")[0] in ("jax", "jaxlib", "scripts")
            or name == "fdreadoutlibs_tpu"
            or name.startswith("fdreadoutlibs_tpu."))

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"jax and the JAX package are blocked: {name}")

sys.meta_path.insert(0, NoJax())
import numpy as np
import torch
torch.set_num_threads(1)
import fdreadoutlibs_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401

from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
for feed in ("time2_feed", "fused_unpack", "words14_feed", None):
    app = APAReadoutApp(n_links=2, algorithm="AbsRS", threshold=150,
                        threshold_on_collection=True, device="cpu",
                        **({feed: True} if feed else {}))
    rng = np.random.default_rng(1)
    for b in range(2):
        app.process_batch(make_batch(rng, 2, 2, b, 0x1000000 + 4096 * b)[0])
    info = app.get_info()
    assert info["total_hits"] > 0 and info["ts_errors"] == 0, (feed, info)

from fdreadoutlibs_tpu_torch.ops import TPGConfig
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest
for kw in ({}, {"fused": True}, {"time2": True}):
    ing = StreamingIngest(TPGConfig(threshold=150), 2, tc=64, device="cpu",
                          **kw)
    rng = np.random.default_rng(2)
    for b in range(2):
        ing.submit(make_batch(rng, 2, 2, b, 0x1000000 + 4096 * b)[0])
    assert len(ing.flush()[0]) > 0, kw

from fdreadoutlibs_tpu_torch.apps import detector_readout, pds_readout
assert detector_readout.main(["--apa-links", "1", "--pds-links", "1",
                              "--tde-links", "1", "--batches", "1",
                              "--tde-backend", "pallas", "--device",
                              "cpu"]) == 0
assert pds_readout.main(["--links", "2", "--batches", "2",
                         "--superchunks-per-batch", "1", "--pipelined",
                         "--device", "cpu"]) == 0
ing = StreamingIngest(TPGConfig(threshold=120), 2, format="daphne_stream",
                      device="cpu")
scs = pds_readout.make_batch(np.random.default_rng(3), 2, 1, 0,
                             signal_rate=1.0)[0]
ing.submit(scs.reshape(2, -1, 472))        # (links, frames, frame bytes)
assert len(ing.flush()[0]) > 0

from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import wib2_superchunks
sc, _ = wib2_superchunks(1, 8, seed=2)
for time2 in (False, True):
    sink = QueueSender()
    proc = WIB2FrameProcessor(tp_sink=sink, device="cpu")
    proc.conf({"crate_id": 1, "slot_id": 0, "link_id": 0, "enable_tpg": True,
               "tpg_algorithm": "FIR", "tpg_threshold": 5,
               "tpg_time2_feed": time2})
    proc.start()
    proc.process(sc[0].copy())
    assert proc.metrics.count("num_tps_sent") > 0

from fdreadoutlibs_tpu_torch.stream import WIBFrameProcessor
from fdreadoutlibs_tpu_torch.testing import protowib_superchunks
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
sc, _ = protowib_superchunks(1, 8, seed=2)
for backend, time2 in (("reference", False), ("scan", False),
                       ("pallas", False), ("pallas", True)):
    proc = WIBFrameProcessor(tp_handler=WIBTPHandler(), device="cpu")
    proc.conf({"enable_tpg": True, "tpg_backend": backend,
               "tpg_time2_feed": time2})
    proc.start()
    proc.process(sc[0].copy())
    assert proc.metrics.count("num_hits") > 0, (backend, time2)

from fdreadoutlibs_tpu_torch.models import run_model
from fdreadoutlibs_tpu_torch.testing import fir_stream
adcs = fir_stream(128, 32, 64, 2, seed=3)
fir = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
hits = [run_model(adcs, fir, b, device="cpu")[0]
        for b in ("reference", "scan", "pallas")]
assert len(hits[0]) > 0 and all(np.array_equal(h, hits[0]) for h in hits)

# the second module slice: the scheduler, the CLI and entry()
import os, tempfile
from fdreadoutlibs_tpu_torch import cli
from fdreadoutlibs_tpu_torch.apps.scheduler import MultiAPAScheduler
from fdreadoutlibs_tpu_torch.entry import entry
sched = MultiAPAScheduler(TPGConfig(threshold=150), n_apas=2, n_links=2,
                          device="cpu")
rng = np.random.default_rng(4)
for apa in (0, 1, 1, 0):
    sched.submit(apa, make_batch(rng, 2, 2, 0, 0x1000000)[0])
got = sched.flush()
assert set(got) == {0, 1} and all(len(h) > 0 for h, _ in got.values())
assert sched.get_info()["batches"] == [2, 2]
fn, args = entry(device="cpu")
hits_e, n_e, _ = fn(*args)
assert int(n_e) == 1 and int(hits_e[0, 0]) == 7
with tempfile.TemporaryDirectory() as td:
    zeros, patt = os.path.join(td, "z.bin"), os.path.join(td, "g.bin")
    assert cli.main(["make-zeros", "-o", zeros, "-n", "2"]) == 0
    assert cli.main(["pattern-generator", "-f", zeros, "-p", "golden",
                     "--output", patt]) == 0
    assert cli.main(["compare-backends", "-f", patt, "-b", "reference",
                     "scan", "pallas", "--device", "cpu"]) == 0

# the third module slice: link-axis sharding, the sharded checkpoint, the
# dry run and the soak, on meshes of the CPU
from fdreadoutlibs_tpu_torch.entry import dryrun_multichip
from fdreadoutlibs_tpu_torch.parallel import (APAPipeline, DetectorPipeline,
                                              make_apa_link_mesh,
                                              make_link_mesh)
from fdreadoutlibs_tpu_torch.probes import soak
from fdreadoutlibs_tpu_torch.utils.checkpoint import (load_sharded_state,
                                                      save_sharded_state)
from fdreadoutlibs_tpu_torch.formats import wibeth
frames = make_batch(np.random.default_rng(5), 4, 2, 0, 0x1000000)[0]
words = wibeth.frames_bytes_to_u32(
    frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(4, 128, 28)
pipe = APAPipeline(4, TPGConfig(threshold=150),
                   mesh=make_link_mesh(2, device="cpu"), backend="pallas",
                   fused_unpack=True)
_, n_p, total = pipe.process(words)
assert total == int(np.asarray(n_p).sum()) and total > 0
with tempfile.TemporaryDirectory() as td:
    save_sharded_state(td + "/s", pipe.state)
    one = APAPipeline(4, TPGConfig(threshold=150),
                      mesh=make_link_mesh(1, device="cpu"), backend="pallas")
    one.init_state(np.zeros((4, 64), np.int32))
    one.state = load_sharded_state(td + "/s", one.state)
    assert np.array_equal(np.asarray(one.state["pedestals"]),
                          np.asarray(pipe.state["pedestals"]))
det = DetectorPipeline(2, 2, TPGConfig(threshold=150),
                       mesh=make_apa_link_mesh(2, 2, device="cpu"))
_, n_d, tot_d = det.process(words.reshape(2, 2, -1, 28))
assert list(tot_d) == list(np.asarray(n_d).sum(axis=1))
dryrun_multichip(2, device="cpu")
soak.check(soak.run(2, 1024, 64, "AbsRS", "time2", "cpu"))

# the probes' entries on CPU tensors run their plain versions
from fdreadoutlibs_tpu_torch import probes
from fdreadoutlibs_tpu_torch.probes import (i16_ops, roofline, slots_ab,
                                            swar_frugal)
x = roofline.chains_input(2, 128, "cpu")
assert torch.equal(roofline.issue_chains(x, 2, 1, 128),
                   roofline.issue_plain(x, 2))
a, b = i16_ops.op_inputs("select_mask", "cpu")
assert i16_ops.one_op("select_mask", a, b).dtype == torch.int16
feeds = i16_ops.mix_inputs(128)
assert torch.equal(i16_ops.mix(feeds["packed"], 4, "packed", 1),
                   i16_ops.mix(feeds["i16"], 4, "i16", 1).view(torch.int32))
swar_frugal.check_parity(swar_frugal.arm_inputs(
    swar_frugal.make_adcs(32, 64), "cpu"))
assert slots_ab.run("cpu", C=64, T=128, families=("AbsRS",))[
    "AbsRS plain"]["hits"] > 0
assert not any(probes.launches.values())
assert not [k for k in sys.modules if blocked(k)]

if not torch.cuda.is_available():
    from fdreadoutlibs_tpu_torch.ops import _build, tpg
    try:
        APAReadoutApp(n_links=1, time2_feed=True, device="cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("device='cuda' without a card did not raise")
    try:
        StreamingIngest(TPGConfig(), 1, device="cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("StreamingIngest on 'cuda' without a card did "
                             "not raise")
    for make in (lambda: MultiAPAScheduler(TPGConfig(), 1, 1),
                 lambda: entry(), lambda: cli.main(
                     ["profile", "--channels", "64", "--ticks", "64"]),
                 lambda: make_link_mesh(), lambda: make_apa_link_mesh(2),
                 lambda: APAPipeline(2, TPGConfig()),
                 lambda: DetectorPipeline(1, 1, TPGConfig()),
                 lambda: dryrun_multichip(2),
                 lambda: soak.main(["--windows", "1"])):
        try:      # "cuda", the default, never carries on without a card
            make()
        except RuntimeError:
            pass
        else:
            raise AssertionError("a slice entry point ran without a card")
    for app_cls in (pds_readout.PDSReadoutApp,
                    detector_readout.DetectorReadoutApp):
        try:
            app_cls(device="cuda")
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"{app_cls.__name__} on 'cuda' without a "
                                 "card did not raise")
    from fdreadoutlibs_tpu_torch.stream import (DAPHNEStreamFrameProcessor,
                                                TDEFrameProcessor)
    for proc_cls in (WIB2FrameProcessor, WIBFrameProcessor,
                     DAPHNEStreamFrameProcessor, TDEFrameProcessor):
        try:
            proc_cls(device="cuda")
        except RuntimeError:
            pass
        else:
            raise AssertionError("a processor on 'cuda' without a card did "
                                 "not raise")
    feed = torch.zeros((32, 64), dtype=torch.int32)
    state = torch.zeros((tpg.KSTATE, 64), dtype=torch.int32)
    try:      # the kernel route never takes CPU tensors
        tpg.launch_kernel(feed, state, TPGConfig(), 64, 2)
    except ValueError:
        pass
    else:
        raise AssertionError("the CUDA kernel route took CPU tensors")
    words = torch.zeros((1, 64, 28), dtype=torch.int32)
    try:      # nor the packed encoding (K4)
        tpg.launch_kernel(words, state, TPGConfig(), 64, 2, False, "frames")
    except ValueError:
        pass
    else:
        raise AssertionError("the CUDA kernel route took CPU packed words")
    fir_state = torch.zeros((tpg.KSTATE, 64), dtype=torch.int32)
    try:      # nor K5, the two-pass FIR schedule
        tpg.launch_kernel(feed, fir_state, fir, 64, 2, fir_twopass=1)
    except ValueError:
        pass
    else:
        raise AssertionError("the CUDA kernel route took CPU tensors (K5)")
    try:      # nor does the wrapper take a device it has no route for
        tpg.process_window(feed.to("meta"), state.to("meta"), TPGConfig(),
                           64, 2)
    except ValueError:
        pass
    else:
        raise AssertionError("process_window took a meta tensor")
    assert tpg.process_window.launches == 0
    for mod in (roofline, i16_ops, swar_frugal, slots_ab):
        try:      # a probe's entry point never carries on without a card
            mod.main([])
        except RuntimeError as e:
            assert "preflight" in str(e), e
        else:
            raise AssertionError(f"{mod.__name__} ran without a card")
    try:
        roofline.probe_arms()
    except (RuntimeError, AssertionError):
        pass
    else:
        raise AssertionError("probe_arms ran without a card")
print("NOJAX OK")
'''


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX OK" in res.stdout


def test_no_module_imports_jax():
    for path in (ROOT / "fdreadoutlibs_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from jax" not in smoke


def _import_roots(path: Path) -> set:
    """The top-level package of every absolute import in a module (at any
    depth: module level, functions, conditionals)."""
    import ast
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    return {n.split(".")[0] for n in names}


def test_no_port_module_imports_the_jax_package():
    """No module of the port imports ``fdreadoutlibs_tpu`` (nor jax, nor the
    JAX package's ``scripts``): the host modules it needs are its own
    copies."""
    paths = sorted((ROOT / "fdreadoutlibs_tpu_torch").rglob("*.py"))
    assert len(paths) > 35
    assert {"roofline.py", "i16_ops.py", "swar_frugal.py", "slots_ab.py",
            "preflight.py", "detector_readout.py", "pds_readout.py",
            "fragment.py", "wire.py", "daphne.py", "tde.py", "ssp.py",
            "recorder.py", "scheduler.py", "cli.py", "entry.py", "scan.py",
            "config.py", "checkpoint.py", "emulator.py", "patterns.py",
            "simulation.py", "variable.py", "mesh.py", "apa.py",
            "soak.py"} <= {p.name for p in paths}
    for path in paths:
        roots = _import_roots(path)
        assert not roots & {"fdreadoutlibs_tpu", "jax", "jaxlib",
                            "scripts"}, (path, roots)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of the JAX package: what it needs of
    the configuration and state seeding comes through the port."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {n.split(".")[0] for n in names}
    assert "fdreadoutlibs_tpu_torch" in roots
    assert not roots & {"fdreadoutlibs_tpu", "jax", "jaxlib", "scripts"}, roots


def test_chip_smoke_fails_without_card():
    """Here there is no card: chip_smoke.py exits non-zero and prints no
    result line."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "torch finds no CUDA device" in res.stderr
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
