"""The port runs with jax unimportable (the machine with the card has no
jax), and refuses CUDA work without a card instead of falling back."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")

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

from fdreadoutlibs_tpu.ops.config import TPGConfig
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest
for kw in ({}, {"fused": True}, {"time2": True}):
    ing = StreamingIngest(TPGConfig(threshold=150), 2, tc=64, device="cpu",
                          **kw)
    rng = np.random.default_rng(2)
    for b in range(2):
        ing.submit(make_batch(rng, 2, 2, b, 0x1000000 + 4096 * b)[0])
    assert len(ing.flush()[0]) > 0, kw

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
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")]

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
    try:
        WIB2FrameProcessor(device="cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("a processor on 'cuda' without a card did not "
                             "raise")
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
    try:      # nor does the wrapper take a device it has no route for
        tpg.process_window(feed.to("meta"), state.to("meta"), TPGConfig(),
                           64, 2)
    except ValueError:
        pass
    else:
        raise AssertionError("process_window took a meta tensor")
    assert tpg.process_window.launches == 0
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
    assert not roots & {"fdreadoutlibs_tpu", "jax", "jaxlib"}, roots


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
