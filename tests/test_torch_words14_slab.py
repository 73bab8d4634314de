"""K4b: the words14 unpack schedules of the port (the plain versions on the
CPU) against the JAX package in Pallas interpret mode: the slab schedule
through ``process_words14_feed(slab=True)`` and the gather formulation
through ``process_window_pallas(words14=True, words14_gather=True)``, also
under the two-pass FIR schedule (K5).  The JAX side keeps state and slots
in the words14 lane positions, the port in canonical channel order; hits,
dropped counts, nclose per channel and the carried state must be equal
(tolerance 0: integer pipeline)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu_torch.formats import wibeth
from fdreadoutlibs_tpu_torch.ops import ingest, tpg
from fdreadoutlibs_tpu_torch.testing import frame_words
from test_torch_words14 import CONFIGS, jax_nclose, stream

torch.set_num_threads(1)

T, TC, K = 256, 64, 2
C = 192                     # 3 links: 12 word groups, one words14 row


def _compare(js, jn, stack, ps, pn, state, pos, b):
    j_hits, j_drop = jtpg.decode_pallas_hits(js, jn, C, tick_offset=b * T,
                                             positions=pos)
    hits, drop = ingest.decode_slots(ps, pn, C, tick_offset=b * T)
    np.testing.assert_array_equal(hits, j_hits)
    assert drop == j_drop
    np.testing.assert_array_equal(pn.numpy(), jax_nclose(jn, pos))
    assert torch.equal(state, tpg.state_from_jax(np.asarray(stack), C,
                                                 positions=pos))
    assert len(hits) > 0
    return drop


def _windows(cfg, seed):
    adcs, rmf = stream(cfg, C, seed)
    pos = jtpg.words14_positions(C)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    W = [native.relayout_words14(frame_words(adcs[b * T:(b + 1) * T]))
         for b in range(2)]
    return W, pos, jtpg.pack_state(st, C, positions=pos), \
        tpg.pack_state(st, C)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_slab_feed_matches_jax(name):
    """process_words14_feed(slab=True), tc = 64 < T: two windows, the slab
    refilled per chunk with state carried across chunks and windows."""
    cfg = CONFIGS[name]
    W, pos, stack, state = _windows(cfg, seed=31)
    drops = 0
    for b in range(2):
        js, jn, stack = jingest.process_words14_feed(
            jnp.asarray(W[b]), stack, cfg, C, tc=TC, k_slots=K, unroll=2,
            interpret=True, slab=True)
        ps, pn, state = ingest.process_words14_feed(
            torch.from_numpy(W[b]), state, cfg, C, tc=TC, k_slots=K,
            slab=True)
        drops += _compare(js, jn, stack, ps, pn, state, pos, b)
    assert drops > 0


@pytest.mark.parametrize("name,fir_twopass",
                         [(n, 0) for n in CONFIGS] + [("FIR", 2),
                                                      ("FIR-peaks", 1)])
def test_gather_matches_jax(name, fir_twopass):
    """words14_gather=True on every family, and in K5's decode."""
    cfg = CONFIGS[name]
    W, pos, stack, state = _windows(cfg, seed=37)
    drops = 0
    for b in range(2):
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(W[b]), stack, cfg, tc=TC, k_slots=K, interpret=True,
            words14=True, words14_gather=True, fir_twopass=fir_twopass)
        ps, pn, state = tpg.process_window(
            torch.from_numpy(W[b]), state, cfg, TC, K, time_packed=False,
            packed14="words14", words14_gather=True,
            fir_twopass=fir_twopass)
        drops += _compare(js, jn, stack, ps, pn, state, pos, b)
    assert drops > 0


def test_gather_unpack_equals_per_class_unpack():
    """The torch gather formulation gives the per-class unpack's samples on
    arbitrary words (every bit set somewhere, lane padding included)."""
    rng = np.random.default_rng(3)
    for L, n in [(2, 16), (33, 8)]:
        words = rng.integers(0, 2 ** 32, size=(L, n, 28), dtype=np.uint32)
        W = torch.from_numpy(native.relayout_words14(words))
        assert torch.equal(wibeth.unpack_words14_gather(W, 64 * L),
                           wibeth.unpack_words14(W, 64 * L))


def test_schedules_in_launch_accounting():
    fir = dataclasses.replace(CONFIGS["FIR"], track_peaks=True)
    assert tpg.kernels_of(fir, False, "words14", words14_slab=True) == \
        ("K4b-slab", "K3")
    assert tpg.kernels_of(CONFIGS["AbsRS"], False, "words14",
                          words14_gather=True) == ("K4b-gather",)
    assert set(tpg.KERNELS) >= {"K2b", "K3b", "K4b-slab", "K4b-gather"}
    tpg.reset_launches()
    assert set(tpg.process_window.kernel_launches) == set(tpg.KERNELS)


def test_fir_packed_counts_as_k3b():
    """With fir_packed in effect the launch runs K3b's code on any feed
    (``tpg_kernel``, ``tpg_slab_kernel`` on the slab): ``kernel_of`` names
    K3b as the function, and ``kernels_of`` keeps the datapath beside it;
    without it, or where it is off (not FIR), the words14 schedules are
    K4b's own."""
    fir = CONFIGS["FIR"]
    feeds = [(True, None, {}), (False, None, {}), (False, "frames", {}),
             (False, "words14", {}),
             (False, "words14", {"words14_gather": True}),
             (False, "words14", {"words14_slab": True})]
    for time2, packed14, opts in feeds:
        assert tpg.kernel_of(fir, time2, packed14, fir_packed=True,
                             **opts) == "K3b", (time2, packed14, opts)
        assert tpg.kernels_of(fir, time2, packed14, fir_packed=True,
                              **opts)[-1] == "K3b"
    assert tpg.kernels_of(fir, False, "words14", fir_packed=True,
                          words14_slab=True) == ("K4b-slab", "K3b")
    assert tpg.kernel_of(fir, False, "words14", words14_slab=True) == \
        "K4b-slab"
    assert tpg.kernel_of(fir, False, "words14", words14_gather=True) == \
        "K4b-gather"
    assert tpg.kernel_of(fir, False, "frames") == "K4"
