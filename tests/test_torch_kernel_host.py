"""The CUDA source itself on the CPU: ``csrc/tpg*.cu`` compiled with the
host C++ compiler against a stand-in CUDA runtime
(``tests/cuda_host/cuda_runtime.h``, ``-DTPG_HOST_EMULATION``: a grid
without barriers runs serially; the blocks of K5, K4b-slab and K4b-gather
run as host threads that meet at a real barrier or shuffle), called
through the wrapper's own argument marshalling (``ops/tpg._launch``) and
held bit-equal to the plain version for every encoding (K1 time2, K2
plain, K4 frame words and words14 rows, K4b-gather and K4b-slab on words14
rows) and family (K3 FIR, K3b with the SWAR carry, the float running sum),
the int16 state (K2b), and K5 (fir_twopass 1 and 2, also through the
gather) for the FIR variants, at a shape with whole 16-tick groups and one
with a ragged chunk tail or a partly empty block and warp.  What only the
card shows (the build for sm_90a, scheduling, timing) is
``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig, _build,
                                         init_chanstate, seed_chanstate, tpg)
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
    "AbsRS-float": TPGConfig.from_raw("AbsRS", threshold=150, rs_float=True),
    "StandardRS-float": TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                  threshold=150, rs_float=True),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel library's translation units compiled with g++ at once,
    as ``ops/_build.py`` compiles them with nvcc, and linked."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("tpg_host")
    objs, _ = _build.compile_units(
        lambda src, obj: [cxx, "-std=c++17", "-O1", "-fPIC", "-pthread",
                          "-x", "c++", "-DTPG_HOST_EMULATION", f"-I{STUB}",
                          "-c", "-o", str(obj), str(src)],
        _build.units("tpg"), out)
    lib = out / "libtpg_host.so"
    res = subprocess.run([cxx, "-shared", "-pthread", "-o", str(lib),
                          *map(str, objs)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_kernel(host_lib):
    fn = host_lib.tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def host_fir2(host_lib):
    fn = host_lib.tpg_fir2_launch
    fn.argtypes = tpg._FIR2_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _inputs(cfg, C, T, tc, k):
    """The window as every encoding the kernel takes, and its state."""
    if cfg.algorithm == Algorithm.FIR:
        adcs, rmf = fir_stream(T, C, tc, k, seed=C), 0
    else:
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C)
    # whole 64-channel links; the kernel reads only the first C channels
    links = np.pad(adcs, ((0, 0), (0, -C % 64)))
    words = torch.from_numpy(frame_words(links).view(np.int32))
    feeds = [(torch.from_numpy(adcs), False, None),
             (torch.from_numpy(time2_words(adcs)), True, None),
             (words, False, "frames"),
             (pack_words14(words), False, "words14")]
    return feeds, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_source_matches_plain(host_kernel, name):
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in [(256, 320, 64), (192, 200, 50)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
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


@pytest.mark.parametrize("fir_twopass", [1, 2])
@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("FIR")])
def test_fir2_kernel_source_matches_plain(host_fir2, name, fir_twopass):
    """K5 (``tpg_fir2_launch``) on every encoding, against K5's plain
    version, which equals K3's (tests/test_torch_fir2.py): a shape whose
    last block is partly empty (C = 200 is not a multiple of 32 channels),
    a ragged chunk tail (tc = 50), window carry across chunks, drops."""
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in [(256, 320, 64), (208, 200, 50)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        want = tpg.process_window_twopass_plain(feeds[0][0], state, cfg, tc,
                                                k, fir_twopass, False)
        for feed, time2, packed14 in feeds:
            if time2 and tc % 2:
                continue
            got = tpg._launch(host_fir2, feed, state, cfg, tc, k, time2,
                              packed14, 0, None, fir_twopass)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, time2, packed14)
        assert int(want[1].max()) > k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_variants_match_plain(host_kernel, name):
    """K4b-gather and K4b-slab on words14 rows, K2b on the int16 state and
    feed, and with fir_packed K3b on every encoding, against their plain
    versions; C = 208 leaves a partly empty block (the slab's barrier) and
    a half warp (the gather's shuffle mask)."""
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in [(256, 320, 64), (208, 192, 48)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        adcs, w14 = feeds[0][0], feeds[3][0]
        for opts in (dict(words14_gather=True), dict(words14_slab=True)):
            want = tpg.process_window_plain(w14, state, cfg, tc, k, False,
                                            "words14", **opts)
            got = tpg._launch(host_kernel, w14, state, cfg, tc, k, False,
                              "words14", 0, None, **opts)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, opts)
        s16 = state.to(torch.int16)
        want = tpg.process_window_plain(adcs.to(torch.int16), s16, cfg, tc,
                                        k, False)
        got = tpg._launch(host_kernel, adcs.to(torch.int16), s16, cfg, tc, k,
                          False, None, 0, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (C, "int16")
        assert int((want[0][:, :, -1] != 0).sum()) > 0
        if cfg.algorithm != Algorithm.FIR:
            continue
        for feed, time2, packed14 in feeds:
            if time2 and tc % 2:
                continue
            for opts in (dict(), dict(words14_gather=True),
                         dict(words14_slab=True)):
                if opts and packed14 != "words14":
                    continue
                want = tpg.process_window_plain(feed, state, cfg, tc, k,
                                                time2, packed14,
                                                fir_packed=True, **opts)
                got = tpg._launch(host_kernel, feed, state, cfg, tc, k,
                                  time2, packed14, 0, None, fir_packed=True,
                                  **opts)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (C, time2, packed14, opts)


@pytest.mark.parametrize("fir_twopass", [1, 2])
def test_fir2_kernel_gather_matches_plain(host_fir2, fir_twopass):
    """K5 through the words14 gather (``tpg_fir2_launch`` with K4b-gather's
    decode) against K5's plain version, a half warp included."""
    cfg = CONFIGS["FIR-peaks-gated"]
    k = 2
    for C, T, tc in [(256, 320, 64), (208, 200, 50)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        w14 = feeds[3][0]
        want = tpg.process_window_twopass_plain(feeds[0][0], state, cfg, tc,
                                                k, fir_twopass, False)
        got = tpg._launch(host_fir2, w14, state, cfg, tc, k, False,
                          "words14", 0, None, fir_twopass,
                          words14_gather=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w), C
