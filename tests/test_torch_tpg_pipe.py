"""The threshold families' warp-specialised pipeline (``csrc/tpg.cuh``,
``pipe_kernel`` in its kPipeThreshold mode: K2 on plain samples, K4 on frame
words and words14 rows), built for the host (``tests/torch_host_lib.py``)
and called through the wrapper's own marshalling (``ops/tpg._launch``),
held directly against the JAX package's
``process_window_pallas(..., interpret=True)`` on the same numpy-made
inputs, over two consecutive windows whose split falls inside a pulse
(state carried through both packages): slots, nclose (drops included) and
the carried state, bit for bit (tolerance 0: an integer pipeline).  The
JAX fused words14 kernel keeps state and slots in the words14 lane
positions, the port in canonical channel order; both are compared in
canonical order."""

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
from fdreadoutlibs_tpu_torch.ops.ingest import pack_words14
from fdreadoutlibs_tpu_torch.testing import frame_words, tpg_stream
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


@pytest.fixture(scope="module")
def host_kernel():
    fn = host_library("tpg").tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _seeded(C, seed):
    """The test stream, and a pulse on channel 2 (memoryless for the RS
    families) that ends on the first window's last tick: the second
    window's first tick closes it from the carried state alone."""
    adcs, rmf = tpg_stream(T, C, TC, K, seed=seed)
    adcs[T // 2 - 4:T // 2, 2] += 2000
    return adcs, seed_chanstate(init_chanstate(C), adcs[0], rmf)


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_pipeline_matches_pallas(host_kernel, name):
    """K2: the pipeline on plain samples against the Pallas kernel on the
    same samples (time_packed=False).  For rs_float, XLA on the CPU
    contracts the interpret-mode kernel's 0.8 * rs + s into one FMA, which
    the JAX package's own oracle does not (ROADMAP.md section 3): there the
    pipeline equals the oracle's state on every channel and the Pallas
    kernel on every channel where that kernel agrees with the oracle."""
    cfg, C = K2_CASES[name]
    adcs, st = _seeded(C, seed=C + 11)
    stack = jtpg.pack_state(st, C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    closes = 0
    for w in range(2):
        win = adcs[w * T // 2:(w + 1) * T // 2]
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(jtpg.pack_adcs(win)), stack, cfg, tc=TC, k_slots=K,
            interpret=True, time_packed=False)
        slots, nclose, state = tpg._launch(
            host_kernel, torch.from_numpy(np.ascontiguousarray(win)), state,
            cfg, TC, K, False, None, 0, None)
        js, jn = jax_outputs_to_port(js, jn, C)
        jstate = tpg.state_from_jax(np.asarray(stack), C)
        ok = np.arange(C)
        if cfg.rs_float:
            _, st = process_window_reference(win, st, cfg)
            got = tpg.unpack_state(state)
            for key in jtpg._STATE_KEYS:
                np.testing.assert_array_equal(got[key], np.asarray(st[key]),
                                              err_msg=key)
            ok = np.nonzero((state == jstate).all(dim=0).numpy())[0]
            assert len(ok) > C * 9 // 10
        np.testing.assert_array_equal(slots.numpy()[..., ok], js[..., ok])
        np.testing.assert_array_equal(nclose.numpy()[:, ok], jn[:, ok])
        np.testing.assert_array_equal(state.numpy()[:, ok],
                                      jstate.numpy()[:, ok])
        assert int((js[:, :, -1] != 0).sum()) > 0
        closes = max(closes, int(jn.max()))
    assert closes > K                              # drops exercised


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
