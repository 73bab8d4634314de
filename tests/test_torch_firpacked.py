"""K3b: the port's FIR tick with the packed SWAR carry (``fir_packed``; the
plain version on the CPU) against the JAX package's
``process_window_pallas(fir_packed=True, interpret=True)`` on the plain,
time2 and words14 encodings, with peaks on and off and both threshold
semantics; and K3b's CUDA source built for the host
(``tests/torch_host_lib.py``) on words14 rows through the slab at a
1024-tick chunk against the same JAX kernel.  Integer pipeline: slots,
nclose and the carried (canonical) state equal bit for bit (tolerance
0)."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)
from test_torch_tpg import jax_outputs_to_port
from test_torch_words14 import jax_nclose
from torch_host_lib import host_library

torch.set_num_threads(1)

T, C, TC, K = 256, 192, 64, 2
FIR = TPGConfig.from_raw("FIR", threshold=5)
CASES = {
    "avx-peaks": FIR,
    "avx-nopeaks": dataclasses.replace(FIR, track_peaks=False),
    "naive-peaks-gated": dataclasses.replace(FIR, fir_avx_semantics=False,
                                             peak_gated=True),
    "naive-nopeaks": dataclasses.replace(FIR, fir_avx_semantics=False,
                                         track_peaks=False),
}


def _jax_window(enc, win, stack, cfg):
    if enc == "words14":
        W = native.relayout_words14(frame_words(win))
        return jtpg.process_window_pallas(
            jnp.asarray(W), stack, cfg, tc=TC, k_slots=K, interpret=True,
            words14=True, fir_packed=True)
    feed = jtpg.pack_adcs_time2(win) if enc == "time2" else \
        jtpg.pack_adcs(win)
    return jtpg.process_window_pallas(
        jnp.asarray(feed), stack, cfg, tc=TC, k_slots=K, interpret=True,
        unroll=2, time_packed=enc == "time2", fir_packed=True)


def _port_feed(enc, win):
    if enc == "words14":
        return torch.from_numpy(native.relayout_words14(frame_words(win))), \
            dict(time_packed=False, packed14="words14")
    if enc == "time2":
        return torch.from_numpy(time2_words(win)), dict(time_packed=True)
    return torch.from_numpy(np.ascontiguousarray(win)), \
        dict(time_packed=False)


@pytest.mark.parametrize("enc", ["plain", "time2", "words14"])
@pytest.mark.parametrize("case", list(CASES))
def test_firpacked_matches_pallas_across_split(case, enc):
    """Two windows, state carried over chunk boundaries and the split; the
    burst chunk closes more than K hits (drops); K3b's results are also
    K3's (the in-range contract of the carry)."""
    cfg = CASES[case]
    adcs = fir_stream(T, C, TC, K, seed=29)
    st = seed_chanstate(init_chanstate(C), adcs[0], 0)
    pos = jtpg.words14_positions(C) if enc == "words14" else None
    stack = jtpg.pack_state(st, C, positions=pos)
    state = tpg.pack_state(st, C)
    half = T // 2
    closes = 0
    for w in range(2):
        win = adcs[w * half:(w + 1) * half]
        js, jn, stack = _jax_window(enc, win, stack, cfg)
        feed, kw = _port_feed(enc, win)
        unpacked = tpg.process_window(feed, state, cfg, TC, K, **kw)
        ps, pn, state = tpg.process_window(feed, state, cfg, TC, K,
                                           fir_packed=True, **kw)
        if pos is None:
            js, jn = jax_outputs_to_port(js, jn, C)
        else:
            s = np.asarray(js)
            js = s.transpose(1, 2, 3, 0, 4, 5).reshape(
                s.shape[1], K, s.shape[3], -1)[..., pos]
            jn = jax_nclose(jn, pos)
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        assert torch.equal(state, tpg.state_from_jax(np.asarray(stack), C,
                                                     positions=pos))
        for g, u in zip((ps, pn, state), unpacked):
            assert torch.equal(g, u)
        closes = max(closes, int(jn.max()))
    assert closes > K


def test_firpacked_off_where_jax_ignores_it():
    """fir_packed on a threshold family, or on an int16 state, is silently
    off (pallas_tpg.py:854-863): the same outputs as without it, as the
    JAX kernel gives with it."""
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    adcs, rmf = tpg_stream(128, 64, TC, K, seed=3)
    st = seed_chanstate(init_chanstate(64), adcs[0], rmf)
    stack = jtpg.pack_state(st, 64)
    js, jn, jst = jtpg.process_window_pallas(
        jnp.asarray(jtpg.pack_adcs(adcs)), stack, cfg, tc=TC, k_slots=K,
        interpret=True, fir_packed=True)
    state = tpg.pack_state(st, 64)
    got = tpg.process_window(torch.from_numpy(adcs), state, cfg, TC, K,
                             time_packed=False, fir_packed=True)
    want = tpg.process_window(torch.from_numpy(adcs), state, cfg, TC, K,
                              time_packed=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    js, jn = jax_outputs_to_port(js, jn, 64)
    np.testing.assert_array_equal(got[0].numpy(), js)
    np.testing.assert_array_equal(tpg.state_to_jax(got[2]), np.asarray(jst))
    fir_adcs = fir_stream(128, 64, TC, K, seed=4).astype(np.int16)
    s16 = tpg.pack_state(seed_chanstate(init_chanstate(64), fir_adcs[0], 0),
                         64, dtype=torch.int16)
    a = tpg.process_window(torch.from_numpy(fir_adcs), s16, FIR, TC, K,
                           time_packed=False, fir_packed=True)
    b = tpg.process_window(torch.from_numpy(fir_adcs), s16, FIR, TC, K,
                           time_packed=False)
    for g, w in zip(a, b):
        assert torch.equal(g, w)
    assert tpg.kernels_of(FIR, False, fir_packed=True) == ("K2", "K3b")
    assert tpg.kernels_of(FIR, True, fir_packed=True) == ("K3b",)


def test_k3b_slab_long_chunk_kernel_matches_pallas():
    """K3b at tc = 1024 on words14 rows through the slab (``fir_packed``
    with ``words14_slab``: 1024 ticks of time2 words of 128 channels would
    outgrow a block's shared memory, and the pipeline stages 32 ticks at a
    time), the CUDA source on the host through the wrapper's marshalling
    (``tpg._launch``), against ``process_window_pallas(fir_packed=True,
    words14_slab=True, interpret=True)`` on the same seeded rows, two
    chunks in one window."""
    fn = host_library("tpg").tpg_launch
    fn.argtypes = tpg._ARGTYPES
    fn.restype = ctypes.c_int
    n, tc = 2048, 1024
    cfg = CASES["avx-peaks"]
    adcs = fir_stream(n, C, tc, K, seed=37)
    st = seed_chanstate(init_chanstate(C), adcs[0], 0)
    pos = jtpg.words14_positions(C)
    stack = jtpg.pack_state(st, C, positions=pos)
    feed, kw = _port_feed("words14", adcs)
    js, jn, stack = jtpg.process_window_pallas(
        jnp.asarray(feed.numpy()), stack, cfg, tc=tc, k_slots=K,
        interpret=True, words14=True, unroll=2, fir_packed=True,
        words14_slab=True)
    ps, pn, state = tpg._launch(fn, feed, tpg.pack_state(st, C), cfg, tc, K,
                                kw["time_packed"], kw["packed14"], 0, None,
                                fir_packed=True, words14_slab=True)
    s = np.asarray(js)
    js = s.transpose(1, 2, 3, 0, 4, 5).reshape(
        s.shape[1], K, s.shape[3], -1)[..., pos]
    jn = jax_nclose(jn, pos)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pn.numpy(), jn)
    assert torch.equal(state, tpg.state_from_jax(np.asarray(stack), C,
                                                 positions=pos))
    assert int((js[:, :, -1] != 0).sum()) > 0
    assert int(jn.max()) > K                       # drops exercised
