"""The port's TPG wrapper (plain version on the CPU) against the JAX
package: ``process_window_pallas(time_packed=True, interpret=True)`` and the
numpy oracle ``ops/reference.py``.  Integer pipeline: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.hits import hits_from_compact
from fdreadoutlibs_tpu.ops.reference import process_window_reference
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.hits import compact_slots
from fdreadoutlibs_tpu_torch.testing import time2_words, tpg_stream

torch.set_num_threads(1)

CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig.from_raw("AbsRS", threshold=150),       # rs_mf_shift=3
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
]
IDS = [c.algorithm.value for c in CONFIGS]
T, C, TC = 256, 200, 128


def _seed(adcs, rmf):
    return seed_chanstate(init_chanstate(adcs.shape[1]), adcs[0], rmf)


def jax_outputs_to_port(slots, nclose, n_channels):
    """JAX (NB, NCH, K, nw, SUB, 128) / (NB, NCH, SUB, 128) -> the port's
    (NCH, K, nw, C) / (NCH, C) layout."""
    s = np.asarray(slots)
    nb, nch, K, nw, sub, lanes = s.shape
    s = s.transpose(1, 2, 3, 0, 4, 5).reshape(nch, K, nw, nb * sub * lanes)
    n = np.asarray(nclose).transpose(1, 0, 2, 3).reshape(nch, -1)
    return s[..., :n_channels], n[:, :n_channels]


def port_hits(slots, nclose, tick_offset=0):
    out, n, dropped = compact_slots(slots, nclose, 4096,
                                    tick_offset=tick_offset)
    return hits_from_compact(out.numpy(), int(n)), int(dropped)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_plain_matches_pallas_across_batch_split(cfg):
    """Two consecutive windows (state carried across the split, pulses
    over chunk and window boundaries, one channel over K closes in a
    chunk): slots, nclose and state equal the Pallas kernel's."""
    k, tc = 2, TC // 2
    adcs, rmf = tpg_stream(T, C, tc, k, seed=3)
    stack = jtpg.pack_state(_seed(adcs, rmf), C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    half = T // 2
    max_closes = []
    for w in range(2):
        win = adcs[w * half:(w + 1) * half]
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(jtpg.pack_adcs_time2(win)), stack, cfg, tc=tc,
            k_slots=k, interpret=True, unroll=2, time_packed=True)
        ps, pn, state = tpg.process_window(
            torch.from_numpy(time2_words(win)), state, cfg, tc=tc,
            k_slots=k)
        js, jn = jax_outputs_to_port(js, jn, C)
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
        max_closes.append(int(jn.max()))
    assert max_closes[0] > k          # the burst chunk dropped hits


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_plain_matches_reference(cfg):
    """Enough slots for every close: the compacted hits and the carried
    state equal the numpy oracle's, and the burst channel's chunk really
    closed more than the test stream's K=2."""
    adcs, rmf = tpg_stream(T, C, TC, 2, seed=5)
    st = _seed(adcs, rmf)
    slots, nclose, state = tpg.process_window(
        torch.from_numpy(time2_words(adcs)), tpg.pack_state(st, C), cfg,
        tc=TC, k_slots=8)
    assert nclose.max().item() > 2
    hits, dropped = port_hits(slots, nclose)
    h_ref, st_ref = process_window_reference(adcs, st, cfg)
    assert dropped == 0 and len(h_ref) > 0
    np.testing.assert_array_equal(hits, h_ref)
    got = tpg.unpack_state(state)
    for key in tpg._STATE_KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(st_ref[key]),
                                      err_msg=key)


def test_plain_unpacked_datapath_matches_reference():
    """time_packed=False (one sample per row, the datapath of K2) on the
    CPU agrees with the oracle too."""
    cfg = CONFIGS[1]
    adcs, rmf = tpg_stream(128, 64, 64, 2, seed=9)
    st = _seed(adcs, rmf)
    slots, nclose, _ = tpg.process_window(
        torch.from_numpy(adcs), tpg.pack_state(st, 64), cfg, tc=64,
        k_slots=8, time_packed=False)
    np.testing.assert_array_equal(port_hits(slots, nclose)[0],
                                  process_window_reference(adcs, st, cfg)[0])


@pytest.mark.parametrize("C_,sub", [(200, None), (1100, 8)])
def test_state_converter_round_trip(C_, sub):
    rng = np.random.default_rng(11)
    st = {k: rng.integers(-3000, 3000, C_).astype(np.int32)
          for k in jtpg._STATE_KEYS}
    st["fir_prev"] = rng.integers(-3000, 3000, (8, C_)).astype(np.int32)
    stack = np.asarray(jtpg.pack_state(st, C_, block_sublanes=sub))
    port = tpg.state_from_jax(stack, C_)
    np.testing.assert_array_equal(port.numpy(),
                                  tpg.pack_state(st, C_).numpy())
    np.testing.assert_array_equal(tpg.state_to_jax(port, sub), stack)
    back = tpg.unpack_state(port)
    ref = jtpg.unpack_state(stack, C_)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)


def test_constants_match_jax():
    assert tpg.KSTATE == jtpg.KSTATE == 23
    assert tpg._STATE_KEYS == jtpg._STATE_KEYS
    for cfg in CONFIGS + [TPGConfig(algorithm=Algorithm.FIR),
                          TPGConfig(algorithm=Algorithm.FIR,
                                    track_peaks=False)]:
        assert tpg.record_words(cfg) == jtpg.record_words(cfg)
        assert tpg.live_fields(cfg) == jtpg.live_fields(cfg)
    for T_ in (64, 128, 192, 8192, 64 * 509, 1000):
        for cap in (256, 512):
            assert tpg.auto_tc(T_, cap) == jtpg.auto_tc(T_, cap)


def test_window_shape_checks():
    cfg = CONFIGS[0]
    state = torch.zeros((tpg.KSTATE, 64), dtype=torch.int32)
    with pytest.raises(ValueError):          # odd tc on the time2 feed
        tpg.process_window(torch.zeros((33, 64), dtype=torch.int32), state,
                           cfg, tc=33, k_slots=2)
    with pytest.raises(ValueError):          # feed narrower than C
        tpg.process_window(torch.zeros((32, 63), dtype=torch.int32), state,
                           cfg, tc=64, k_slots=2)
    with pytest.raises(ValueError):          # not int32
        tpg.process_window(torch.zeros((32, 64), dtype=torch.int64), state,
                           cfg, tc=64, k_slots=2)
