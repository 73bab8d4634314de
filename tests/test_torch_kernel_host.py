"""The CUDA source itself on the CPU: ``csrc/tpg.cu`` compiled with the
host C++ compiler against a stand-in CUDA runtime
(``tests/cuda_host/cuda_runtime.h``, ``-DTPG_HOST_EMULATION``: the grid
runs serially), called through the wrapper's own argument marshalling
(``ops/tpg._launch``) and held bit-equal to the plain version for every
encoding (K1 time2, K2 plain, K4 frame words and words14 rows) and family
(K3 FIR included), at a shape with whole 16-tick groups and one with a
ragged chunk tail.  What only the card shows (the build for sm_90a,
scheduling, timing) is ``tests/test_torch_cuda.py``'s and
``chip_smoke.py``'s."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu_torch.ops import _build, tpg
from fdreadoutlibs_tpu_torch.ops.ingest import pack_words14
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)

torch.set_num_threads(1)

STUB = Path(__file__).resolve().parent / "cuda_host"
_FIR = TPGConfig.from_raw("FIR", threshold=5)
CONFIGS = {
    "Simple": TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    "Simple-gated-neg": TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                  threshold=-5, peak_gated=True),
    "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
    "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    "FIR": dataclasses.replace(_FIR, track_peaks=False),
    "FIR-peaks-gated": dataclasses.replace(_FIR, peak_gated=True),
    "FIR-naive": dataclasses.replace(_FIR, fir_avx_semantics=False),
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    lib = tmp_path_factory.mktemp("tpg_host") / "libtpg_host.so"
    res = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
         "-DTPG_HOST_EMULATION", f"-I{STUB}", "-o", str(lib),
         str(_build.CSRC_DIR / "tpg.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(lib)).tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_source_matches_plain(host_kernel, name):
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in [(256, 320, 64), (192, 200, 50)]:
        if cfg.algorithm == Algorithm.FIR:
            adcs, rmf = fir_stream(T, C, tc, k, seed=C), 0
        else:
            adcs, rmf = tpg_stream(T, C, tc, k, seed=C)
        state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0],
                                              rmf), C)
        words = torch.from_numpy(frame_words(adcs).view(np.int32))
        feeds = [(torch.from_numpy(adcs), False, None),
                 (torch.from_numpy(time2_words(adcs)), True, None),
                 (words, False, "frames"),
                 (pack_words14(words), False, "words14")]
        want = tpg.process_window_plain(feeds[0][0], state, cfg, tc, k,
                                        False)
        for feed, time2, packed14 in feeds:
            if time2 and tc % 2:
                continue
            got = tpg._launch(host_kernel, feed, state, cfg, tc, k, time2,
                              packed14, 0, None)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, time2, packed14)
        assert int((want[0][:, :, -1] != 0).sum()) > 0
