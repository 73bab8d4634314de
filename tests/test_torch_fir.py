"""The port's plain version of the FIR family (K3) and of the plain-sample
datapath (K2) against the JAX package: ``process_window_pallas(...,
interpret=True)`` and the numpy oracle ``ops/reference.py``.  Integer
pipeline: exact equality of slots, nclose and state (FIR ring rows
included)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.fir import tpg_tick_fir
from fdreadoutlibs_tpu.ops.reference import process_window_reference
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.xp import TorchXP, make_fx
from fdreadoutlibs_tpu_torch.testing import fir_stream, time2_words, \
    tpg_stream
from test_torch_tpg import jax_outputs_to_port, port_hits

torch.set_num_threads(1)

T, C, TC, K = 256, 200, 64, 2
FIR = TPGConfig.from_raw("FIR", threshold=5)
FIR_CASES = {
    "avx-nopeaks": dataclasses.replace(FIR, track_peaks=False),
    "avx-peaks": FIR,
    "avx-peaks-gated": dataclasses.replace(FIR, peak_gated=True),
    "naive-nopeaks": dataclasses.replace(FIR, track_peaks=False,
                                         fir_avx_semantics=False),
    "naive-peaks": dataclasses.replace(FIR, fir_avx_semantics=False),
    "custom-taps": dataclasses.replace(FIR, taps=(3, -2, 9, 27, 9, -2, 3, 0),
                                       track_peaks=False),
    "short-taps": dataclasses.replace(FIR, taps=(4, 12, 32, 12, 4)),
    # a*T >= 2^31: fir_threshold keeps the intermediate wrap
    "pathological-threshold": dataclasses.replace(FIR, threshold=1000,
                                                  track_peaks=False),
}


def _seed(adcs):
    return seed_chanstate(init_chanstate(adcs.shape[1]), adcs[0], 0)


def _feeds(win, time_packed):
    """The same window for Pallas (padded tiles) and for the port."""
    if time_packed:
        return jtpg.pack_adcs_time2(win), time2_words(win)
    return jtpg.pack_adcs(win), np.ascontiguousarray(win)


def _run_split(cfg, adcs, time_packed, tc, k):
    """Two consecutive windows through Pallas (interpret) and the port's
    plain version, state carried across the split; every output equal.
    Returns the per-chunk close counts."""
    stack = jtpg.pack_state(_seed(adcs), C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    half = adcs.shape[0] // 2
    closes = []
    for w in range(2):
        j_in, p_in = _feeds(adcs[w * half:(w + 1) * half], time_packed)
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(j_in), stack, cfg, tc=tc, k_slots=k, interpret=True,
            unroll=2, time_packed=time_packed)
        ps, pn, state = tpg.process_window(
            torch.from_numpy(p_in), state, cfg, tc=tc, k_slots=k,
            time_packed=time_packed)
        js, jn = jax_outputs_to_port(js, jn, C)
        assert ps.shape[2] == tpg.record_words(cfg)
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
        closes.append(jn)
    return np.concatenate(closes)


@pytest.mark.parametrize("time_packed", [True, False],
                         ids=["time2", "plain"])
@pytest.mark.parametrize("case", list(FIR_CASES))
def test_fir_plain_matches_pallas_across_split(case, time_packed):
    """The split at T/2 is a chunk boundary that pulses straddle, so the
    carried FIR ring and open hits are load-bearing; the burst channel
    closes more than K hits in one chunk (drops)."""
    adcs = fir_stream(T, C, TC, K, seed=7)
    closes = _run_split(FIR_CASES[case], adcs, time_packed, TC, K)
    assert closes.max() > K


@pytest.mark.parametrize("case", ["avx-nopeaks", "avx-peaks", "naive-peaks",
                                  "custom-taps", "pathological-threshold"])
def test_fir_plain_matches_reference(case):
    """Enough slots for every close: the compacted hits and the carried
    state (ring rows included) equal the numpy oracle's."""
    cfg = FIR_CASES[case]
    adcs = fir_stream(T, C, TC, K, seed=11)
    st = _seed(adcs)
    slots, nclose, state = tpg.process_window(
        torch.from_numpy(adcs), tpg.pack_state(st, C), cfg, tc=TC,
        k_slots=32, time_packed=False)
    hits, dropped = port_hits(slots, nclose)
    h_ref, st_ref = process_window_reference(adcs, st, cfg)
    assert dropped == 0 and len(h_ref) > 0
    np.testing.assert_array_equal(hits, h_ref)
    got = tpg.unpack_state(state)
    for key in tpg._STATE_KEYS + ("fir_prev",):
        np.testing.assert_array_equal(got[key], np.asarray(st_ref[key]),
                                      err_msg=key)


def test_fir_tick_array_ring_matches_tuple_ring():
    """TorchXP runs ``tpg_tick_fir`` with the ring as one (8, C) tensor
    (zeros_like + concatenate) exactly as with the tuple the plain
    version carries."""
    cfg = FIR_CASES["avx-peaks"]
    adcs = fir_stream(64, 32, 64, 1, seed=2)
    st0 = {k: torch.from_numpy(np.asarray(v).copy())
           for k, v in _seed(adcs).items() if k != "fir_phase"}
    xp = TorchXP("cpu")
    fx = make_fx(xp)
    taps = (1, 6, 15, 20, 15, 6, 1, 0)
    st_a = dict(st0)
    st_t = dict(st0, fir_prev=tuple(st0["fir_prev"]))
    for t in range(64):
        s = torch.from_numpy(adcs[t])
        st_a, ca, ra = tpg_tick_fir(st_a, s, cfg, xp, taps, fx=fx)
        st_t, ct, rt = tpg_tick_fir(st_t, s, cfg, xp, taps, fx=fx)
        assert torch.equal(ca, ct)
        for k in ra:
            assert torch.equal(ra[k], rt[k]), k
    assert torch.equal(st_a["fir_prev"], torch.stack(st_t["fir_prev"]))


THRESHOLD_CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig.from_raw("AbsRS", threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
]


@pytest.mark.parametrize("cfg", THRESHOLD_CONFIGS,
                         ids=[c.algorithm.value for c in THRESHOLD_CONFIGS])
def test_plain_datapath_matches_pallas_across_split(cfg):
    """K2's plain version: one int32 sample per row, the three threshold
    families, state carried across a split that pulses straddle."""
    adcs, rmf = tpg_stream(T, C, TC, K, seed=3)
    stack = jtpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                            C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    half = T // 2
    max_closes = 0
    for w in range(2):
        win = adcs[w * half:(w + 1) * half]
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(jtpg.pack_adcs(win)), stack, cfg, tc=TC, k_slots=K,
            interpret=True, unroll=2)
        ps, pn, state = tpg.process_window(
            torch.from_numpy(np.ascontiguousarray(win)), state, cfg, tc=TC,
            k_slots=K, time_packed=False)
        js, jn = jax_outputs_to_port(js, jn, C)
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
        max_closes = max(max_closes, int(jn.max()))
    assert max_closes > K
