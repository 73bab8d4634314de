"""The threshold families' warp-specialised pipeline (``csrc/tpg.cuh``,
``pipe_kernel`` in its kPipeThreshold mode: K1 on time2 rows, K2 on plain
samples, K4 on frame words and words14 rows; K2b, every family on the
int16 state, in that mode and, for FIR, in K3's; K4b-gather and K4b-slab,
every family on words14 rows through the gather and the slab, in those
modes, the slab also at a chunk of one and a half stages and at a chunk of
1024 ticks), built for the host
(``tests/torch_host_lib.py``)
and called through the wrapper's own marshalling (``ops/tpg._launch``),
held directly against the JAX package's
``process_window_pallas(..., interpret=True)`` on the same numpy-made
inputs, over two consecutive windows whose split falls inside a pulse
(state carried through both packages): slots, nclose (drops included) and
the carried state, bit for bit (tolerance 0: an integer pipeline), with
the direct store and, on one case of K1, of K2b and of each K4b schedule,
the ``SLOT_WORD_CARRY`` emission layout.  The
JAX fused words14 kernel keeps state and slots in the words14 lane
positions, the port in canonical channel order; both are compared in
canonical order."""

import collections
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.reference import process_window_reference
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.ingest import (decode_slots, pack_words14,
                                                process_words14_feed)
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)
from fdreadoutlibs_tpu_torch.utils.tuning import Geometry
from test_torch_tpg import jax_outputs_to_port
from torch_host_lib import host_library

torch.set_num_threads(1)

T, TC, K = 256, 64, 2
# (family config, channels): AbsRS's memory factors in
# threshold-on-collection style; C = 96 and 64 are whole warps of the
# pipeline but no whole 128-lane JAX row
K2_CASES = {
    "AbsRS": (TPGConfig.from_raw("AbsRS", threshold=150), 96),
    "SimpleThreshold": (TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                  threshold=120), 64),
    "StandardRS-rs_float": (TPGConfig(algorithm=Algorithm.STANDARD_RS,
                                      threshold=60, rs_float=True), 128),
}
K4_CASES = {
    "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
    "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
}
# K1 on time2 rows: (family config, channels)
K1_CASES = {
    "SimpleThreshold": (TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                  threshold=120), 64),
    "AbsRS": (TPGConfig.from_raw("AbsRS", threshold=150), 96),
    "AbsRS-rs_float": (TPGConfig.from_raw("AbsRS", threshold=150,
                                          rs_float=True), 96),
    "StandardRS": (TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
                   128),
}
# K2b on the int16 state: (family config, channels), FIR through K3's mode
K2B_CASES = {
    "SimpleThreshold": (TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                  threshold=120), 96),
    "AbsRS": (TPGConfig.from_raw("AbsRS", threshold=150), 64),
    "StandardRS": (TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
                   96),
    "FIR": (TPGConfig.from_raw("FIR", threshold=5), 64),
}
# (case, SLOT_WORD_CARRY): every case with the direct store, one with the
# carry layout
K1_RUNS = [(n, False) for n in K1_CASES] + [("AbsRS", True)]
K2B_RUNS = [(n, False) for n in K2B_CASES] + [("FIR", True)]
# K4b on words14 rows (128 channels: 8 word groups of one words14 row)
K4B_CASES = {
    "SimpleThreshold": TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD,
                                 threshold=120),
    "AbsRS": TPGConfig.from_raw("AbsRS", threshold=150),
    "AbsRS-rs_float": TPGConfig.from_raw("AbsRS", threshold=150,
                                         rs_float=True),
    "StandardRS": TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    "FIR": TPGConfig.from_raw("FIR", threshold=5),
}
# (schedule, case, SLOT_WORD_CARRY, window ticks, tc): every case of both
# schedules with the direct store at TC, one of each with the carry layout,
# and the slab at tc = 48 (a 32-tick stage, then a ragged 16-tick one) and
# at tc = 1024 (above the 896 ticks a chunk-wide slab of 128 channels could
# hold in a block's shared memory)
K4B_RUNS = [(sched, n, False, T // 2, TC) for sched in ("gather", "slab")
            for n in K4B_CASES] + \
    [("gather", "AbsRS", True, T // 2, TC), ("slab", "FIR", True, T // 2, TC),
     ("slab", "AbsRS", False, 144, 48), ("slab", "StandardRS", True, 144, 48),
     ("slab", "AbsRS", False, 1024, 1024)]

# the slab at a tuned geometry whose group does not divide its chunk: group
# 32 (a candidate of the tuner) at tc = 48
SLAB_GEOMETRY, SLAB_TC = Geometry(32, 32, 4), 48


@pytest.fixture(scope="module")
def host_lib():
    return host_library("tpg")


@pytest.fixture(scope="module")
def host_kernel(host_lib):
    fn = host_lib.tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _seeded(C, seed, fir=False, n=T // 2, tc=TC):
    """The test stream of two windows of n ticks in chunks of tc (the FIR
    family's with ``fir``), and a pulse on channel 2 (memoryless for the RS
    families) that ends on the first window's last tick: the second
    window's first tick closes it from the carried state alone."""
    if fir:
        adcs, rmf = fir_stream(2 * n, C, tc, K, seed), 0
    else:
        adcs, rmf = tpg_stream(2 * n, C, tc, K, seed=seed)
    adcs[n - 4:n, 2] += 2000
    return adcs, seed_chanstate(init_chanstate(C), adcs[0], rmf)


def _rs_float_channels(cfg, win, st, state, jstate, slots, nclose, tc,
                       share=0.9):
    """For rs_float, where XLA on the CPU contracts the interpret-mode
    kernel's 0.8 * rs + s into one FMA, which the JAX package's own oracle
    does not (ROADMAP.md section 3): the pipeline equals the oracle on every
    channel (its state; nclose, the oracle's closes counted per chunk and
    channel; the slots, decoded as ``ingest.decode_slots`` does, the first
    K of those closes), and the channels where its state equals the Pallas
    kernel's (more than ``share`` of them) are compared with that kernel.
    Returns (those channels, the oracle's state after the window); every
    channel for the other configurations."""
    C = state.shape[1]
    if not cfg.rs_float:
        return np.arange(C), st
    hits, st = process_window_reference(win, st, cfg)
    got = tpg.unpack_state(state)
    for key in jtpg._STATE_KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(st[key]),
                                      err_msg=key)
    chunk = hits["end_tick"] // tc
    want_n = np.zeros(tuple(nclose.shape), dtype=np.int32)
    np.add.at(want_n, (chunk, hits["channel"]), 1)
    np.testing.assert_array_equal(nclose.numpy(), want_n)
    # hits are in (end_tick, channel) order: a chunk's closes of a channel
    # come in tick order, and its K slots keep the first K
    seen = collections.Counter()
    kept = np.zeros(len(hits), dtype=bool)
    for i, key in enumerate(zip(chunk.tolist(), hits["channel"].tolist())):
        kept[i] = seen[key] < slots.shape[1]
        seen[key] += 1
    decoded, dropped = decode_slots(slots, nclose, C)
    np.testing.assert_array_equal(decoded, hits[kept])
    assert dropped == int((~kept).sum())
    ok = np.nonzero((state == jstate).all(dim=0).numpy())[0]
    assert len(ok) > int(C * share)
    return ok, st


def _windows_match_pallas(host_lib, host_kernel, cfg, C, adcs, st,
                          time2=False, dtype=np.int32):
    """The two windows of ``adcs`` through the Pallas kernel (interpret
    mode) and the host-built pipeline (``host_kernel``, the C entry of
    ``host_lib``), state carried through both: plain
    samples, time2 words (``time2``) or int16 samples and state (``dtype``
    np.int16).  For rs_float, as :func:`_rs_float_channels` says."""
    stack = jtpg.pack_state(st, C, dtype=dtype)
    state = tpg.state_from_jax(np.asarray(stack), C)
    closes = 0
    for w in range(2):
        win = adcs[w * T // 2:(w + 1) * T // 2]
        if time2:
            jfeed, feed = jtpg.pack_adcs_time2(win), time2_words(win)
        else:
            jfeed, feed = jtpg.pack_adcs(win, dtype=dtype), win.astype(dtype)
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(jfeed), stack, cfg, tc=TC, k_slots=K,
            interpret=True, time_packed=time2, unroll=2 if time2 else 1)
        slots, nclose, state = tpg._launch(
            host_kernel, torch.from_numpy(np.ascontiguousarray(feed)), state,
            cfg, TC, K, time2, None, 0, None, lib=host_lib)
        js, jn = jax_outputs_to_port(js, jn, C)
        jstate = tpg.state_from_jax(np.asarray(stack), C)
        ok, st = _rs_float_channels(cfg, win, st, state, jstate, slots,
                                    nclose, TC)
        np.testing.assert_array_equal(slots.numpy()[..., ok], js[..., ok])
        np.testing.assert_array_equal(nclose.numpy()[:, ok], jn[:, ok])
        np.testing.assert_array_equal(state.numpy()[:, ok],
                                      jstate.numpy()[:, ok])
        assert state.dtype == (torch.int16 if dtype == np.int16
                               else torch.int32)
        assert int((js[:, :, -1] != 0).sum()) > 0
        closes = max(closes, int(jn.max()))
    assert closes > K                              # drops exercised


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_pipeline_matches_pallas(host_lib, host_kernel, name):
    """K2: the pipeline on plain samples against the Pallas kernel on the
    same samples (time_packed=False); rs_float as
    :func:`_windows_match_pallas` says."""
    cfg, C = K2_CASES[name]
    adcs, st = _seeded(C, seed=C + 11)
    _windows_match_pallas(host_lib, host_kernel, cfg, C, adcs, st)


@pytest.mark.parametrize("name,carry", K1_RUNS,
                         ids=[n + ("-carry" if c else "") for n, c in K1_RUNS])
def test_k1_pipeline_matches_pallas(host_lib, host_kernel, name, carry,
                                   monkeypatch):
    """K1: the pipeline on time2 rows (its loader stages 16 rows of two
    ticks each per 32-tick stage) against the Pallas kernel on the same
    time2 words (time_packed=True)."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", carry)
    cfg, C = K1_CASES[name]
    adcs, st = _seeded(C, seed=C + 17)
    _windows_match_pallas(host_lib, host_kernel, cfg, C, adcs, st,
                          time2=True)


@pytest.mark.parametrize("name,carry", K2B_RUNS,
                         ids=[n + ("-carry" if c else "")
                              for n, c in K2B_RUNS])
def test_k2b_pipeline_matches_pallas(host_lib, host_kernel, name, carry,
                                    monkeypatch):
    """K2b: the pipeline on int16 samples and state (the threshold mode;
    K3's for FIR) against the Pallas kernel on the JAX package's int16
    stack (``pack_state(dtype=np.int16)``)."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", carry)
    cfg, C = K2B_CASES[name]
    adcs, st = _seeded(C, seed=C + 19, fir=cfg.algorithm == Algorithm.FIR)
    _windows_match_pallas(host_lib, host_kernel, cfg, C, adcs, st,
                          dtype=np.int16)


@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_pipeline_matches_pallas(host_kernel, name):
    """K4: the pipeline on frame words (L, T, 28) and on words14 rows (T,
    WR, 7, 128), both against the Pallas kernel on the words14 rows
    (``words14=True``: the in-kernel 14-bit unpack)."""
    cfg = K4_CASES[name]
    C = 128
    adcs, st = _seeded(C, seed=C + 13)
    pos = jtpg.words14_positions(C)
    stack = jtpg.pack_state(st, C, positions=pos)
    start = tpg.state_from_jax(np.asarray(stack), C, positions=pos)
    states = {"frames": start, "words14": start}
    closes = 0
    for w in range(2):
        words = frame_words(adcs[w * T // 2:(w + 1) * T // 2])
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(native.relayout_words14(words)), stack, cfg, tc=TC,
            k_slots=K, interpret=True, words14=True)
        js, jn = jax_outputs_to_port(js, jn, int(pos.max()) + 1)
        js, jn = js[..., pos], jn[:, pos]
        jstate = tpg.state_from_jax(np.asarray(stack), C, positions=pos)
        frames = torch.from_numpy(words.view(np.int32))
        for layout, feed in (("frames", frames),
                             ("words14", pack_words14(frames))):
            slots, nclose, states[layout] = tpg._launch(
                host_kernel, feed, states[layout], cfg, TC, K, False, layout,
                0, None)
            np.testing.assert_array_equal(slots.numpy(), js, err_msg=layout)
            np.testing.assert_array_equal(nclose.numpy(), jn,
                                          err_msg=layout)
            assert torch.equal(states[layout], jstate), layout
        closes = max(closes, int(jn.max()))
    assert closes > K


@pytest.mark.parametrize(
    "sched,name,carry,n,tc", K4B_RUNS,
    ids=[f"{sc}-{nm}" + ("-carry" if c else "") + (f"-tc{tc}" if tc != TC
                                                  else "")
         for sc, nm, c, _, tc in K4B_RUNS])
def test_k4b_pipeline_matches_pallas(host_lib, host_kernel, sched, name,
                                     carry, n, tc, monkeypatch):
    """K4b-gather and K4b-slab: the pipeline on words14 rows (the gather:
    K4's decode of the staged rows; the slab: warp 0 unpacks each staged
    stage into a time2 slab and runs K1's front on it) against the Pallas
    kernel's words14 schedules on the same rows (``words14_gather=True``;
    ``words14_slab=True`` with unroll 2), two windows of n ticks with the
    state carried; rs_float as :func:`_rs_float_channels` says (the
    contraction depends on the interpret-mode kernel's unrolling: the
    gather's, unroll 1, meets it on 16 of these 128 channels, so there the
    Pallas kernel is held on more than three quarters of them, and the
    oracle's slots, nclose and state on all of them)."""
    monkeypatch.setattr(tpg, "SLOT_WORD_CARRY", carry)
    cfg = K4B_CASES[name]
    C = 128
    adcs, st = _seeded(C, seed=C + 23, fir=cfg.algorithm == Algorithm.FIR,
                       n=n, tc=tc)
    pos = jtpg.words14_positions(C)
    stack = jtpg.pack_state(st, C, positions=pos)
    state = tpg.state_from_jax(np.asarray(stack), C, positions=pos)
    opts = {f"words14_{sched}": True}
    closes = 0
    for w in range(2):
        win = adcs[w * n:(w + 1) * n]
        words = frame_words(win)
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(native.relayout_words14(words)), stack, cfg, tc=tc,
            k_slots=K, interpret=True, words14=True,
            unroll=2 if sched == "slab" else 1, **opts)
        slots, nclose, state = tpg._launch(
            host_kernel, pack_words14(torch.from_numpy(words.view(np.int32))),
            state, cfg, tc, K, False, "words14", 0, None, lib=host_lib,
            **opts)
        js, jn = jax_outputs_to_port(js, jn, int(pos.max()) + 1)
        js, jn = js[..., pos], jn[:, pos]
        jstate = tpg.state_from_jax(np.asarray(stack), C, positions=pos)
        ok, st = _rs_float_channels(cfg, win, st, state, jstate, slots,
                                    nclose, tc,
                                    0.75 if sched == "gather" else 0.9)
        np.testing.assert_array_equal(slots.numpy()[..., ok], js[..., ok])
        np.testing.assert_array_equal(nclose.numpy()[:, ok], jn[:, ok])
        np.testing.assert_array_equal(state.numpy()[:, ok],
                                      jstate.numpy()[:, ok])
        assert int((js[:, :, -1] != 0).sum()) > 0
        closes = max(closes, int(jn.max()))
    assert closes > K                              # drops exercised


def test_slab_at_a_group_that_does_not_divide_tc(monkeypatch):
    """The slab at a tuned geometry of group 32 with tc = 48, a chunk of one
    and a half groups: the launch warns, naming both geometries, and takes
    the shipped geometry's library (``host_library("tpg",
    geometry_defines(None))``, no define) instead of refusing.  Over two
    windows carrying state its slots, nclose and state equal the plain
    version's, and ``ingest.process_words14_feed(slab=True)`` on the CPU
    gives the same with the tuned geometry (warning too) as with none."""
    asked = []

    def lib_of(geometry=None):
        asked.append(geometry)
        return host_library("tpg", tpg.geometry_defines(geometry))
    monkeypatch.setattr(tpg, "library", lib_of)
    cfg, C, n = K4B_CASES["AbsRS"], 128, 3 * SLAB_TC
    adcs, st = _seeded(C, seed=C + 29, n=n, tc=SLAB_TC)
    state = plain = tpg.pack_state(st, C)
    warned = (r"group=32 of geometry \(32, 32, 4\); launching with the "
              r"shipped geometry \(16, 32, 4\)")
    closes = 0
    for w in range(2):
        feed = pack_words14(torch.from_numpy(
            frame_words(adcs[w * n:(w + 1) * n]).view(np.int32)))
        with pytest.warns(UserWarning, match=warned):
            lib = tpg.library(tpg._check_geometry(SLAB_GEOMETRY, cfg,
                                                  SLAB_TC, 0, True))
        assert asked == [None] * (w + 1)
        slots, nclose, state = tpg._launch(
            tpg._kernel_fn(0, lib), feed, state, cfg, SLAB_TC, K, False,
            "words14", 0, None, words14_slab=True, lib=lib)
        with pytest.warns(UserWarning, match=warned):
            tuned = process_words14_feed(feed, plain, cfg, C, tc=SLAB_TC,
                                         k_slots=K, slab=True,
                                         geometry=SLAB_GEOMETRY)
        want = process_words14_feed(feed, plain, cfg, C, tc=SLAB_TC,
                                    k_slots=K, slab=True)
        for what, got, t, exp in zip(("slots", "nclose", "state"),
                                     (slots, nclose, state), tuned, want):
            assert torch.equal(got, exp) and torch.equal(t, exp), (w, what)
        plain = want[2]
        assert int((slots[:, :, -1] != 0).sum()) > 0
        closes = max(closes, int(nclose.max()))
    assert closes > K                              # drops exercised
