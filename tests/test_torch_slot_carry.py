"""The ``SLOT_WORD_CARRY`` emission layout of the port against the JAX
package's (``fdreadoutlibs_tpu/ops/pallas_tpg.py:67``), on the CPU: the
cases of ``tests/test_tpg_pallas.py::test_slot_word_carry_layout_bitexact``
(128 ticks x 48 channels, tc 32, the three threshold families and FIR
without peaks) with the JAX flag flipped inside the test and restored, at
k = 2, a k that overflows (1) and a k above the port's register ceiling (6).
Slots, nclose and carried state: tolerance 0.  On the CPU the port's wrapper
runs the plain version, which the layout does not change; the CUDA source of
the layout runs in ``tests/test_torch_kernel_host.py`` and on the card in
``tests/test_torch_cuda.py``.  The wrapper's count of the layout's shared
memory is the C entry's of the kernel library built for the host
(``tests/torch_host_lib.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.probes.slots_ab import slot_word_carry
from fdreadoutlibs_tpu_torch.testing import time2_words
from tests.test_torch_tpg import jax_outputs_to_port
from tests.test_tpg_scan import random_stream
from torch_host_lib import host_library

torch.set_num_threads(1)

CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    TPGConfig(algorithm=Algorithm.FIR, threshold=5, track_peaks=False),
]
IDS = [c.algorithm.value for c in CONFIGS]
T, C, TC = 128, 48, 32


def _jax_window(adcs, stack, cfg, k, carry, time2):
    """One window through the Pallas kernel in interpret mode with the JAX
    flag set for the trace and restored."""
    orig = jtpg.SLOT_WORD_CARRY
    jtpg.SLOT_WORD_CARRY = carry
    try:
        feed = jtpg.pack_adcs_time2(adcs) if time2 else jtpg.pack_adcs(adcs)
        # a distinct vmem_limit_mb forces a retrace: the flag is trace-time
        # state that the jit cache key cannot see (unused in interpret mode)
        return jtpg.process_window_pallas(
            jnp.asarray(feed), stack, cfg, tc=TC, k_slots=k, interpret=True,
            unroll=2 if time2 else 1, time_packed=time2,
            vmem_limit_mb=63 if carry else None)
    finally:
        jtpg.SLOT_WORD_CARRY = orig


@pytest.mark.parametrize("time2", [False, True], ids=["plain", "time2"])
@pytest.mark.parametrize("k", [2, 1, 6])
@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_slot_word_carry_matches_jax(cfg, k, time2):
    adcs = np.asarray(random_stream(T, C, seed=31), dtype=np.int32)
    st = seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10)
    stack = jtpg.pack_state(st, C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    feed = torch.from_numpy(time2_words(adcs) if time2 else adcs)
    jax_out = {}
    for carry in (False, True):
        js, jn, jstack = _jax_window(adcs, stack, cfg, k, carry, time2)
        js, jn = jax_outputs_to_port(js, jn, C)
        jax_out[carry] = (js, jn, np.asarray(jstack))
        with slot_word_carry(carry):
            assert tpg.SLOT_WORD_CARRY is carry
            ps, pn, pstate = tpg.process_window(feed, state, cfg, tc=TC,
                                                k_slots=k, time_packed=time2)
        assert tpg.SLOT_WORD_CARRY is False            # restored
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        np.testing.assert_array_equal(tpg.state_to_jax(pstate),
                                      np.asarray(jstack))
    for a, b in zip(jax_out[False], jax_out[True]):
        np.testing.assert_array_equal(a, b)
    n_hits = int((jax_out[True][0][:, :, -1] != 0).sum())
    assert n_hits > 0
    if k == 1:
        assert int(jax_out[True][1].max()) > k          # closes dropped


class _Recorder:
    """A stand-in C entry that keeps its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture(scope="module")
def host_lib():
    """The kernel library built for the host: its ``tpg_shared_bytes``
    counts the carry layout's shared memory for the wrapper."""
    return host_library("tpg")


@pytest.mark.parametrize("fir_twopass", [0, 1])
def test_flag_is_read_at_launch(host_lib, fir_twopass):
    """The wrapper passes the flag's value of the moment of the launch to
    the C entry; K5's entry gets 0 whatever the flag (``_fir2_kernel`` never
    reads it)."""
    cfg = CONFIGS[3]
    state = torch.zeros((tpg.KSTATE, 64), dtype=torch.int32)
    feed = torch.zeros((64, 64), dtype=torch.int32)
    fn = _Recorder()
    # the flag stands before (lift,) device, stream
    at = -4 if fir_twopass else -3
    tpg._launch(fn, feed, state, cfg, 32, 2, False, None, 0, None,
                fir_twopass)
    with slot_word_carry():
        tpg._launch(fn, feed, state, cfg, 32, 2, False, None, 0, None,
                    fir_twopass, lib=host_lib)
    tpg._launch(fn, feed, state, cfg, 32, 2, False, None, 0, None,
                fir_twopass)
    assert [c[at] for c in fn.calls] == [0, 0 if fir_twopass else 1, 0]
    assert len(fn.calls[0]) == len(
        tpg._FIR2_ARGTYPES if fir_twopass else tpg._ARGTYPES)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_carry_shared_bytes(host_lib, cfg):
    """The staging holds the slots above the register ceiling, and never
    more than a chunk can close, after the pipeline's ring and mbarriers
    (K4b-slab's time2 slabs in the ring; K3b's ring is K3's), as the C
    entry counts them; a k that needs more than a block's shared memory
    raises before any launch."""
    nw = tpg.record_words(cfg)
    slabs = 2 if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD else 3
    ring = slabs * 4 * 4096 + 160

    def need(tc, k, enc=tpg._PLAIN):
        got, most = tpg.carry_shared_bytes(cfg, tc, k, enc, host_lib)
        assert most == 232448
        return got
    assert need(256, 4) == ring
    assert need(256, 6) == ring + 2 * nw * 32 * 4
    assert need(32, 1000) == ring + 12 * nw * 32 * 4
    assert need(256, 4, tpg._SLAB14) == ring + 4 * 4096
    state = torch.zeros((tpg.KSTATE, 64), dtype=torch.int32)
    feed = torch.zeros((2048, 64), dtype=torch.int32)
    fn = _Recorder()
    with slot_word_carry():
        with pytest.raises(ValueError, match="SLOT_WORD_CARRY"):
            tpg._launch(fn, feed, state, cfg, 2048, 1000, False, None, 0,
                        None, lib=host_lib)
    assert not fn.calls
    tpg._launch(fn, feed, state, cfg, 2048, 1000, False, None, 0, None)
    assert len(fn.calls) == 1             # the direct store takes it
