"""The CUDA source itself on the CPU: ``csrc/tpg*.cu`` (the
``SLOT_WORD_CARRY`` units ``csrc/tpg_carry_*.cu`` among them) and
``csrc/probes*.cu`` compiled with the host C++ compiler against a stand-in
CUDA runtime
(``tests/cuda_host/cuda_runtime.h``, ``-DTPG_HOST_EMULATION``; built
once by ``tests/torch_host_lib.py``: a grid without barriers runs
serially; the blocks of the pipeline (K2, K3, K4, K5), K4b-slab and
K4b-gather run as host threads that meet at a real barrier or shuffle),
called
through the wrapper's own argument marshalling (``ops/tpg._launch``) and
held bit-equal to the plain version for every encoding (K1 time2, K2
plain, K4 frame words and words14 rows, K4b-gather and K4b-slab on words14
rows) and family (K3 FIR, K3b with the SWAR carry, the float running sum),
the int16 state (K2b), and K5 (fir_twopass 1 and 2, also through the
gather) for the FIR variants, at a shape with whole 16-tick groups and one
with a ragged chunk tail or a partly empty block and warp; the pipeline
(K3 on plain, time2 and packed rows, K5, K1, K2, K4 and K2b for the
threshold families, K2b for FIR, the staged arms; its warps as host
threads, its stage barriers and copies the stand-in's) also at ProtoWIB
plane widths, partly empty warps and 7-word groups, chunks that are no
whole stage, and K2b's int16 feed at odd and even strides.  The carry
layout runs every encoding and variant with the flag flipped, below, at and
above its register ceiling; the probes' kernels (P1-P3) run through their
modules' own marshalling against their plain versions.  What only the
card shows (the build for sm_90a, scheduling, timing) is
``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu_torch.ops import (Algorithm, TPGConfig,
                                         init_chanstate, seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.ops.ingest import pack_words14
from fdreadoutlibs_tpu_torch.probes import i16_ops, roofline, swar_frugal
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)
from torch_host_lib import host_library

torch.set_num_threads(1)

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
def host_lib():
    return host_library("tpg")


@pytest.fixture(scope="module")
def host_probes():
    return host_library("probes")


@pytest.fixture
def carry():
    """``tpg.SLOT_WORD_CARRY`` flipped for one test and restored."""
    orig = tpg.SLOT_WORD_CARRY
    tpg.SLOT_WORD_CARRY = True
    yield
    tpg.SLOT_WORD_CARRY = orig


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


def _inputs(cfg, C, T, tc, k, split_pulse=False):
    """The window as every encoding the kernel takes, and its state; with
    ``split_pulse`` a pulse on channel 2 (memoryless for the RS families)
    ends on tick T / 2 - 1, so a second window from T / 2 closes it on its
    first tick from the carried state alone."""
    if cfg.algorithm == Algorithm.FIR:
        adcs, rmf = fir_stream(T, C, tc, k, seed=C), 0
    else:
        adcs, rmf = tpg_stream(T, C, tc, k, seed=C)
    if split_pulse:
        adcs[T // 2 - 4:T // 2, 2] += 2000
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


# K3's and K5's shapes on the pipeline (csrc/tpg.cuh::fir_pipe_kernel,
# 32-channel blocks, 32-tick stages): whole stages; a last block partly
# empty (C = 208) with a ragged tail that is no whole 16-tick group
# (tc = 50); 96 and 160 channels, a ProtoWIB plane's, with tc = 112 (whole
# groups, not whole stages) and tc = 150 (neither); several chunks each.
PIPE_SHAPES = [(256, 320, 64), (208, 200, 50), (96, 336, 112),
               (160, 300, 150)]


@pytest.mark.parametrize("fir_twopass", [1, 2, 0])
@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("FIR")])
def test_fir2_kernel_source_matches_plain(host_kernel, host_fir2, name,
                                          fir_twopass):
    """The FIR pipeline on every encoding at PIPE_SHAPES: K5
    (``tpg_fir2_launch``, fir_twopass 1 and 2) against K5's plain version,
    which equals K3's (tests/test_torch_fir2.py), and K3 (``tpg_launch``,
    fir_twopass 0; K4's FIR on packed words) against its own; state carried
    across chunks, drops."""
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in PIPE_SHAPES:
        feeds, state = _inputs(cfg, C, T, tc, k)
        want = tpg.process_window_twopass_plain(
            feeds[0][0], state, cfg, tc, k, fir_twopass, False) \
            if fir_twopass else tpg.process_window_plain(
                feeds[0][0], state, cfg, tc, k, False)
        for feed, time2, packed14 in feeds:
            if time2 and tc % 2:
                continue
            got = tpg._launch(host_fir2 if fir_twopass else host_kernel,
                              feed, state, cfg, tc, k, time2, packed14, 0,
                              None, fir_twopass)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, tc, time2, packed14)
        assert int(want[1].max()) > k


@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("FIR")])
def test_fir_staged_arm_source_matches_plain(host_lib, name):
    """The pipeline's staged arm (``tpg_fir_staged_launch``: one warp, the
    whole tick on the staged feed) on plain and time2 rows at PIPE_SHAPES,
    against K3's plain version."""
    fn = host_lib.tpg_fir_staged_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    cfg = CONFIGS[name]
    k = 2
    for C, T, tc in PIPE_SHAPES:
        feeds, state = _inputs(cfg, C, T, tc, k)
        want = tpg.process_window_plain(feeds[0][0], state, cfg, tc, k,
                                        False)
        for feed, time2, _ in feeds[:2]:
            if time2 and tc % 2:
                continue
            got = tpg._launch(fn, feed, state, cfg, tc, k, time2, None, 0,
                              None)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, tc, time2)


# The threshold pipeline's shapes (csrc/tpg.cuh::pipe_kernel,
# kPipeThreshold, 32-channel blocks, 32-tick stages): C = 40 and 100 leave
# the last warp partly empty (plain samples only: packed words come in
# 16-channel groups), C = 48 and 80 a last warp of one 7-word group; tc =
# 48, 50 and 160 are no whole stage (50 no whole group); K = 1, and K = 5
# and 6 above the carry layout's register ceiling.  The burst channel closes
# K + 2 hits in a chunk where its running sum does not merge them.
THRESHOLD_PIPE_SHAPES = [(40, 192, 48, 2), (100, 200, 50, 1),
                         (48, 320, 160, 6), (80, 384, 96, 5)]
THRESHOLDS = [n for n in CONFIGS if not n.startswith("FIR")]


def _halves(feed, packed14, T, time2=False):
    """A feed of T ticks as two windows of T / 2 (a chunk boundary, where
    the test stream holds a pulse); time2 rows hold two ticks each."""
    if packed14 == "frames":                  # (L, T, 28)
        return [feed[:, :T // 2].contiguous(), feed[:, T // 2:].contiguous()]
    half = T // 4 if time2 else T // 2
    return [feed[:half].contiguous(), feed[half:].contiguous()]


def _two_windows(fn, feed, state, cfg, tc, k, packed14, T, time2=False):
    """fn's results on two consecutive windows, state carried."""
    out = []
    for half in _halves(feed, packed14, T, time2):
        got = fn(half, state, cfg, tc, k, packed14, time2)
        state = got[2]
        out.append(got)
    return out


def _plain(feed, state, cfg, tc, k, packed14, time2=False):
    return tpg.process_window_plain(feed, state, cfg, tc, k, time2, packed14)


def _host_launch(fn):
    """A window through the host-built C entry ``fn`` (``tpg._launch``)."""
    def launch(feed, state, cfg, tc, k, packed14, time2=False):
        return tpg._launch(fn, feed, state, cfg, tc, k, time2, packed14, 0,
                           None)
    return launch


def _assert_windows_equal(got, want, *what):
    for n, (gw, ww) in enumerate(zip(got, want)):
        for g, w in zip(gw, ww):
            assert torch.equal(g, w), what + (n,)


@pytest.mark.parametrize("slot_word_carry", [False, True],
                         ids=["direct", "carry"])
@pytest.mark.parametrize("name", THRESHOLDS)
def test_threshold_pipeline_source_matches_plain(host_kernel, name,
                                                 slot_word_carry,
                                                 monkeypatch):
    """K1, K2 and K4 (the threshold families on time2 rows, plain samples,
    frame words and words14 rows) and K2b (int16 samples and state)
    through the pipeline at THRESHOLD_PIPE_SHAPES, with the direct store
    and with ``SLOT_WORD_CARRY``, against the plain version: slots, nclose
    with drops, and state, over two windows whose split falls inside a
    pulse (the hit warp's first previous over flag comes from the carried
    state)."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", slot_word_carry)
    cfg = CONFIGS[name]
    drops = 0
    kernel = _host_launch(host_kernel)
    for C, T, tc, k in THRESHOLD_PIPE_SHAPES:
        feeds, state = _inputs(cfg, C, T, tc, k, split_pulse=True)
        want = _two_windows(_plain, feeds[0][0], state, cfg, tc, k, None, T)
        drops += max(int(w[1].max()) for w in want) > k
        for feed, time2, packed14 in feeds:
            if packed14 and C % 16:
                continue
            got = _two_windows(kernel, feed, state, cfg, tc, k, packed14, T,
                               time2)
            _assert_windows_equal(got, want, C, tc, k, time2, packed14)
        adcs16, s16 = feeds[0][0].to(torch.int16), state.to(torch.int16)
        want = _two_windows(_plain, adcs16, s16, cfg, tc, k, None, T)
        got = _two_windows(kernel, adcs16, s16, cfg, tc, k, None, T)
        _assert_windows_equal(got, want, C, tc, k, "int16")
    assert drops >= 1


# K2b's int16 feed at both stride parities: C = 45 and 77 with the feed as
# wide as the state (an odd stride: each lane loads its own sample and
# stores it into the slab) and one column wider (an even stride: 4-byte
# copies of sample pairs, the last pair's high half past the channels);
# chunks that are no whole stage, K above the carry ceiling.
INT16_STRIDE_SHAPES = [(45, 192, 48, 2), (77, 320, 160, 5)]


@pytest.mark.parametrize("slot_word_carry", [False, True],
                         ids=["direct", "carry"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_int16_pipeline_feed_stride_source_matches_plain(
        host_kernel, name, slot_word_carry, monkeypatch):
    """K2b (every family on the int16 state; FIR in K3's mode) at an odd C
    with an odd and an even ``feed_stride``, the synchronous feed and the
    word copies, against the plain version over two windows whose split
    falls inside a pulse."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", slot_word_carry)
    cfg = CONFIGS[name]
    kernel = _host_launch(host_kernel)
    drops = 0
    for C, T, tc, k in INT16_STRIDE_SHAPES:
        feeds, state = _inputs(cfg, C, T, tc, k, split_pulse=True)
        adcs16, s16 = feeds[0][0].to(torch.int16), state.to(torch.int16)
        want = _two_windows(_plain, adcs16, s16, cfg, tc, k, None, T)
        drops += max(int(w[1].max()) for w in want) > k
        for pad in (0, 1):
            feed = torch.nn.functional.pad(adcs16, (0, pad)).contiguous()
            assert feed.shape[1] % 2 == 1 - pad          # odd, then even
            got = _two_windows(kernel, feed, s16, cfg, tc, k, None, T)
            _assert_windows_equal(got, want, C, tc, k, feed.shape[1])
    assert drops >= 1


@pytest.mark.parametrize("name", THRESHOLDS)
def test_threshold_staged_arm_source_matches_plain(host_lib, name):
    """The threshold pipeline's staged arm (``tpg_threshold_staged_launch``:
    one warp, ThresholdChannel's whole tick on the staged feed) on time2
    rows, plain samples, packed words and int16 samples and state at
    THRESHOLD_PIPE_SHAPES, against the plain version; it refuses the FIR
    family."""
    fn = host_lib.tpg_threshold_staged_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    cfg = CONFIGS[name]
    for C, T, tc, k in THRESHOLD_PIPE_SHAPES:
        feeds, state = _inputs(cfg, C, T, tc, k)
        want = tpg.process_window_plain(feeds[0][0], state, cfg, tc, k,
                                        False)
        for feed, time2, packed14 in feeds:
            if packed14 and C % 16:
                continue
            got = tpg._launch(fn, feed, state, cfg, tc, k, time2, packed14,
                              0, None)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, tc, k, time2, packed14)
        adcs16, s16 = feeds[0][0].to(torch.int16), state.to(torch.int16)
        want = tpg.process_window_plain(adcs16, s16, cfg, tc, k, False)
        got = tpg._launch(fn, adcs16, s16, cfg, tc, k, False, None, 0, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (C, tc, k, "int16")
    feeds, state = _inputs(cfg, 64, 128, 64, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpg._launch(fn, feeds[0][0], state, CONFIGS["FIR"], 64, 2, False,
                    None, 0, None)


@pytest.mark.parametrize("slot_word_carry", [False, True],
                         ids=["direct", "carry"])
@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("FIR")])
def test_fir_pipeline_packed_source_matches_plain(host_kernel, name,
                                                  slot_word_carry,
                                                  monkeypatch):
    """K4's FIR (K3's pipeline on packed words, ``pipe_kernel<kPacked14,
    kPipeK3>``) on frame words and words14 rows with a last warp of one
    7-word group (C = 48, 80), chunks that are no whole stage, K = 1 and
    above the carry ceiling, against the plain version."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", slot_word_carry)
    cfg = CONFIGS[name]
    for C, T, tc, k in [(48, 200, 50, 1), (80, 320, 160, 6)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        want = tpg.process_window_plain(feeds[0][0], state, cfg, tc, k,
                                        False)
        assert int(want[1].max()) > k
        for feed, _, packed14 in feeds[2:]:
            got = tpg._launch(host_kernel, feed, state, cfg, tc, k, False,
                              packed14, 0, None)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, tc, k, packed14)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_variants_match_plain(host_kernel, name):
    """K4b-gather and K4b-slab on words14 rows (the pipeline), K2b on the
    int16 state and feed, and with fir_packed K3b on every encoding (its
    one-thread-per-channel kernels), against their plain versions; C = 208
    leaves a partly empty block (the pipeline's last warp of one 7-word
    group and 16 idle lanes; K3b's slab barrier) and a half warp (K3b's
    shuffle mask on the gather)."""
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


@pytest.mark.parametrize("sched", ["gather", "slab"])
@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("FIR")])
def test_k3b_words14_kernels_match_plain(host_kernel, name, sched):
    """K3b on words14 rows through the gather and the slab: ``fir_packed``
    keeps the one-thread-per-channel kernels (``tpg_kernel``'s warp
    shuffle, ``tpg_slab_kernel``'s chunk slab), against the plain version,
    at a partly empty block and a half warp (C = 208) and a chunk with a
    16-tick tail; at tc = 1024 the chunk slab of 128 channels outgrows a
    block's shared memory and the slab kernel refuses the launch, where
    K4b-slab's pipeline, a stage at a time, takes the same chunk."""
    cfg = CONFIGS[name]
    k = 2
    opts = {f"words14_{sched}": True}
    for C, T, tc in [(208, 192, 48), (256, 320, 64)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        w14 = feeds[3][0]
        want = tpg.process_window_plain(w14, state, cfg, tc, k, False,
                                        "words14", fir_packed=True, **opts)
        got = tpg._launch(host_kernel, w14, state, cfg, tc, k, False,
                          "words14", 0, None, fir_packed=True, **opts)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (C, tc)
        assert int(want[1].max()) > k
    if sched == "slab":
        feeds, state = _inputs(cfg, 64, 1024, 1024, k)
        w14 = feeds[3][0]
        with pytest.raises(RuntimeError, match="CUDA error"):
            tpg._launch(host_kernel, w14, state, cfg, 1024, k, False,
                        "words14", 0, None, fir_packed=True, **opts)
        want = tpg.process_window_plain(w14, state, cfg, 1024, k, False,
                                        "words14", **opts)
        got = tpg._launch(host_kernel, w14, state, cfg, 1024, k, False,
                          "words14", 0, None, **opts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_word_carry_source_matches_plain(host_kernel, carry, name):
    """The ``SLOT_WORD_CARRY`` units on every encoding and variant against
    the plain version (which the layout does not change): k = 2 within the
    register ceiling with drops, k = 5 and 6 above it (the shared-memory
    staging; the burst channel closes k + 2 hits in a chunk), tc = 200 a
    ragged chunk tail, C = 208 a partly empty block and a half warp."""
    cfg = CONFIGS[name]
    is_fir = cfg.algorithm == Algorithm.FIR
    for C, T, tc, k in [(256, 320, 64, 2), (208, 400, 200, 5),
                        (208, 384, 192, 6)]:
        feeds, state = _inputs(cfg, C, T, tc, k)
        adcs, w14 = feeds[0][0], feeds[3][0]
        want = tpg.process_window_plain(adcs, state, cfg, tc, k, False)
        assert int(want[1].max()) > k
        runs = [(f, state, dict(time_packed=t2, packed14=p14))
                for f, t2, p14 in feeds]
        runs.append((w14, state, dict(time_packed=False, packed14="words14",
                                      words14_gather=True)))
        if tc % 16 == 0:
            runs.append((w14, state, dict(time_packed=False,
                                          packed14="words14",
                                          words14_slab=True)))
        if is_fir:
            runs += [(f, s0, dict(kw, fir_packed=True)) for f, s0, kw in runs]
        for feed, s0, kw in runs:
            got = tpg._launch(host_kernel, feed, s0, cfg, tc, k,
                              kw.pop("time_packed"), kw.pop("packed14"), 0,
                              None, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (C, k, kw)
        s16 = state.to(torch.int16)
        want = tpg.process_window_plain(adcs.to(torch.int16), s16, cfg, tc,
                                        k, False)
        got = tpg._launch(host_kernel, adcs.to(torch.int16), s16, cfg, tc, k,
                          False, None, 0, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (C, k, "int16")


def test_slot_word_carry_any_k(host_kernel, carry):
    """A k far above what a chunk can close carries ceil(tc / 2) slots and
    leaves the others zero; a staging that cannot fit a block's shared
    memory raises instead of taking the direct store."""
    cfg = CONFIGS["AbsRS"]
    C, T, tc = 64, 128, 64
    feeds, state = _inputs(cfg, C, T, tc, 3)
    for k in (1, 3, 4, 1000):
        want = tpg.process_window_plain(feeds[0][0], state, cfg, tc, k,
                                        False)
        got = tpg._launch(host_kernel, feeds[0][0], state, cfg, tc, k, False,
                          None, 0, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w), k
    # the pipeline (K2): 32 channels' staging after its ring of 4 stages of
    # 3 slabs and its 20 mbarriers
    assert tpg.carry_shared_bytes(cfg, 64, 1000) == \
        28 * 3 * 32 * 4 + 3 * 4 * 4096 + 160
    big = torch.zeros((1024, C), dtype=torch.int32)
    with pytest.raises(ValueError, match="SLOT_WORD_CARRY"):
        tpg._launch(host_kernel, big, state, cfg, 1024, 1000, False, None, 0,
                    None)


@pytest.mark.parametrize("name", ["Simple", "AbsRS", "FIR",
                                  "FIR-peaks-gated"])
def test_carry_shared_bytes_matches_source(host_lib, name):
    """The wrapper's refusal and the launch's own are one rule:
    ``tpg.carry_shared_bytes`` and ``tpg._SHARED_MAX`` against the C entry
    built from ``csrc/tpg.cuh``'s constants (``fused_shared_bytes``: record
    words 3 and 2, the pipeline's slabs of each family), below, at and
    above the register ceiling, on plain rows and on words14 rows with the
    slab (the pipeline's time2 slab), and for FIR with ``fir_packed`` (K3b:
    ``tpg_kernel``, and ``tpg_slab_kernel``'s chunk slab)."""
    cfg = CONFIGS[name]
    fn = host_lib.tpg_shared_bytes
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    most = ctypes.c_int(0)
    packed = (False, True) if cfg.algorithm == Algorithm.FIR else (False,)
    args = (tpg._FAMILY[cfg.algorithm], int(cfg.track_peaks))
    for tc in (2, 31, 32, 200, 256, 512, 2048):
        for k in (1, 3, 4, 5, 17, 155, 156, 1000, 100000):
            for slab in (False, True):
                for fir_packed in packed:
                    enc = tpg._SLAB14 if slab else tpg._PLAIN
                    want = fn(tc, k, enc, *args, int(fir_packed), 1,
                              ctypes.byref(most))
                    assert tpg.carry_shared_bytes(cfg, tc, k, slab,
                                                  fir_packed) == want, \
                        (tc, k, slab, fir_packed)
    assert most.value == tpg._SHARED_MAX
    # without the carry layout the ring (with K4b-slab's time2 slabs) and
    # its mbarriers are left, or K3b's slab of a chunk
    slabs = 2 if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD else 3
    assert fn(256, 1000, tpg._SLAB14, *args, 0, 0, None) == \
        (slabs + 1) * 4 * 4096 + 160
    assert fn(256, 1000, tpg._PLAIN, *args, 0, 0, None) == \
        slabs * 4 * 4096 + 160
    if cfg.algorithm == Algorithm.FIR:
        assert fn(256, 1000, tpg._SLAB14, *args, 1, 0, None) == \
            128 * tpg._BLOCK * 4
        assert fn(256, 1000, tpg._GATHER14, *args, 1, 0, None) == 0


# the fused launch's other encodings: time2 rows (K1), packed words (K4),
# words14 rows through the gather (K4b-gather), int16 samples (K2b; the
# csrc/tpg.cuh encoding kPlain16, which fir_packed does not take)
OTHER_ENCODINGS = {"time2": tpg._TIME2, "packed14": tpg._PACKED14,
                   "gather14": tpg._GATHER14, "int16": 5}


@pytest.mark.parametrize("enc", list(OTHER_ENCODINGS))
@pytest.mark.parametrize("name", ["Simple", "AbsRS", "FIR",
                                  "FIR-peaks-gated"])
def test_carry_shared_bytes_every_encoding(host_lib, name, enc):
    """``tpg.carry_shared_bytes`` on the encodings that stage no time2 slab
    equals the C entry's count for that encoding (``fused_shared_bytes``:
    the pipeline's ring of ``pipe_slabs`` slabs, the slab count the launch
    itself takes, and its staging; K3b's ``tpg_kernel`` with
    ``fir_packed``), with and without the carry layout."""
    cfg = CONFIGS[name]
    fn = host_lib.tpg_shared_bytes
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    code = OTHER_ENCODINGS[enc]
    packed = (False, True) if cfg.algorithm == Algorithm.FIR and \
        enc != "int16" else (False,)
    args = (tpg._FAMILY[cfg.algorithm], int(cfg.track_peaks))
    for tc in (2, 32, 200, 2048):
        for k in (1, 4, 5, 156, 100000):
            for fir_packed in packed:
                want = fn(tc, k, code, *args, int(fir_packed), 1, None)
                assert tpg.carry_shared_bytes(cfg, tc, k, False,
                                              fir_packed) == want, \
                    (tc, k, fir_packed)
    slabs = 2 if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD else 3
    assert fn(256, 1000, code, *args, 0, 0, None) == \
        slabs * 4 * 4096 + 160


@pytest.mark.parametrize("ilp", [1, 2, 4, 8, 16])
def test_issue_probe_source_matches_plain(host_probes, ilp):
    """P1's kernel on the script's arange chains and on seeded full-range
    ones; 3 blocks of 40 threads is no whole warp."""
    for blocks, threads, n_iters in [(2, 128, 3), (3, 40, 5)]:
        n = blocks * threads
        rng = np.random.default_rng(ilp)
        for x in (roofline.chains_input(ilp, n, "cpu"),
                  torch.from_numpy(rng.integers(
                      -2**31, 2**31, size=(ilp, n)).astype(np.int32))):
            got = roofline.issue_launch(host_probes, x, n_iters, blocks,
                                        threads)
            assert torch.equal(got, roofline.issue_plain(x, n_iters))


@pytest.mark.parametrize("name", i16_ops.OP_NAMES)
def test_i16_op_source_matches_plain(host_probes, name):
    """P2's one-op kernels on the script's inputs and on a seeded draw over
    the whole int16 range (wraps, the sign masks, -32768)."""
    for seed in (None, 5):
        a, b = i16_ops.op_inputs(name, "cpu", seed)
        got = i16_ops.op_launch(host_probes, name, a, b)
        assert torch.equal(got, i16_ops.op_plain(name, a, b)), seed


@pytest.mark.parametrize("arm", i16_ops.ARMS)
def test_i16_mix_source_matches_plain(host_probes, arm):
    """P2's mix: every arm against its plain version; the packed arm's
    words are the int16 arm's elements."""
    blocks, per_block, n_iters = 3, 80, 50
    feeds = i16_ops.mix_inputs(blocks * per_block)
    a = feeds[arm]
    got = i16_ops.mix_launch(host_probes, a, n_iters, arm, blocks,
                             a.shape[1] // blocks)
    assert torch.equal(got, i16_ops.mix_plain(a, n_iters, arm))
    if arm == "packed":
        i16 = i16_ops.mix_launch(host_probes, feeds["i16"], n_iters, "i16",
                                 blocks, per_block)
        assert torch.equal(i16.view(torch.int32), got)


@pytest.mark.parametrize("arm", swar_frugal.ARMS)
def test_frugal_probe_source_matches_plain(host_probes, arm):
    """P3's kernels: T = 200 leaves an 8-tick tail after the 16-tick
    groups, 200 channels a partly empty block; every packed arm equals
    unpacked after un-biasing and its plain version."""
    inputs = swar_frugal.arm_inputs(swar_frugal.make_adcs(200, 200, seed=3),
                                    "cpu")
    adc, m0, a0 = inputs[arm]
    got = swar_frugal.frugal_launch(host_probes, adc, m0, a0, arm)
    want = swar_frugal.frugal(adc, m0, a0, arm)           # the plain version
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], m0)                    # medians moved
    mu, au = swar_frugal.unpacked_plain(*inputs["unpacked"])
    if arm != "unpacked":
        assert torch.equal(swar_frugal.unpack_pairs(got[0], swar_frugal.BA),
                           mu)
        assert torch.equal(swar_frugal.unpack_pairs(got[1], swar_frugal.BC),
                           au)
    # a feed wider than the state: the stride is the feed's
    wide = torch.nn.functional.pad(adc, (0, 5)).contiguous()
    again = swar_frugal.frugal_launch(host_probes, wide, m0, a0, arm)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
