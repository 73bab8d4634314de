"""The kernel wrapper's variants against the JAX package: the float running
sum (``rs_float``, ProcessNaiveRS) in the plain version against
``process_window_pallas(interpret=True)`` and the numpy oracle, the
rounding it shares with the JAX package at the float32 edge, and every
argument rule of ``process_window_pallas`` (:829-876) for the int16 state,
``fir_packed``, ``fir_twopass`` and the words14 schedules: the port raises
ValueError where the JAX package raises, and ignores what it ignores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native
from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import ingest as jingest
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops import step as jstep
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.reference import (process_window_reference,
                                             run_reference)
from fdreadoutlibs_tpu_torch.ops import ingest, reference, step, tpg
from fdreadoutlibs_tpu_torch.ops.xp import TorchXP
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)
from test_torch_tpg import jax_outputs_to_port

torch.set_num_threads(1)

T, C, TC, K = 256, 200, 64, 2
RS_FLOAT = [TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150,
                      rs_float=True),
            TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=60,
                      rs_float=True)]
RS_IDS = ["AbsRS", "StandardRS"]


@pytest.mark.parametrize("time_packed", [True, False],
                         ids=["time2", "plain"])
@pytest.mark.parametrize("cfg", RS_FLOAT, ids=RS_IDS)
def test_rs_float_matches_pallas_across_split(cfg, time_packed):
    """Two windows, state carried across chunks and the split, drops.

    XLA on the CPU contracts the interpret-mode kernel's 0.8 * rs + |s| / 2
    into one FMA, which ops/step.py and the JAX package's own oracle do not
    (ROADMAP.md section 3); the port rounds each op as step.py does.  So
    the port's state equals the oracle's on every channel, and its slots,
    nclose and state equal the Pallas kernel's on every channel where the
    kernel agrees with the oracle (a channel that parted once stays apart:
    13 of 200 after 256 ticks of AbsRS time2)."""
    adcs, rmf = tpg_stream(T, C, TC, K, seed=41)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    stack = jtpg.pack_state(st, C)
    state = tpg.state_from_jax(np.asarray(stack), C)
    half = T // 2
    closes, fused = 0, set()
    for w in range(2):
        win = adcs[w * half:(w + 1) * half]
        j_in = jtpg.pack_adcs_time2(win) if time_packed else \
            jtpg.pack_adcs(win)
        p_in = time2_words(win) if time_packed else np.ascontiguousarray(win)
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(j_in), stack, cfg, tc=TC, k_slots=K, interpret=True,
            unroll=2, time_packed=time_packed)
        ps, pn, state = tpg.process_window(torch.from_numpy(p_in), state, cfg,
                                           TC, K, time_packed=time_packed)
        _, st = process_window_reference(win, st, cfg)
        got = tpg.unpack_state(state)
        jst = jtpg.unpack_state(stack, C)
        for k in jtpg._STATE_KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(st[k]),
                                          err_msg=k)
            fused |= set(np.nonzero(jst[k] != got[k])[0].tolist())
        ok = np.setdiff1d(np.arange(C), sorted(fused))
        js, jn = jax_outputs_to_port(js, jn, C)
        np.testing.assert_array_equal(ps.numpy()[..., ok], js[..., ok])
        np.testing.assert_array_equal(pn.numpy()[:, ok], jn[:, ok])
        closes = max(closes, int(jn.max()))
    assert closes > K
    assert len(fused) < C // 10, sorted(fused)


@pytest.mark.parametrize("cfg", RS_FLOAT, ids=RS_IDS)
def test_rs_float_oracle_matches_jax_oracle(cfg):
    """The port's numpy oracle runs the float branch as the JAX one does."""
    adcs, _ = tpg_stream(128, 64, 64, K, seed=43)
    h_j, st_j = run_reference(adcs, cfg)
    h_p, st_p = reference.run_reference(adcs, cfg)
    assert len(h_j) > 0
    np.testing.assert_array_equal(h_p, h_j)
    for k in ("rs", "pedestals_rs", "accum_rs"):
        np.testing.assert_array_equal(np.asarray(st_p[k]),
                                      np.asarray(st_j[k]), err_msg=k)


def test_round_half_away_edge():
    """std::round as trunc(v + copysign(0.5, v)) in float32, not roundf:
    0.49999997f + 0.5f rounds up to 1.0f, so it gives 1 (roundf gives 0);
    the port's torch and numpy forms agree with the JAX package's."""
    v = np.array([0.49999997, -0.49999997, 0.5, -0.5, 1.5, 2.5, -2.5,
                  0.0, 8388609.0, -8388609.0, 12345.499], dtype=np.float32)
    want = np.asarray(jstep._round_half_away(v, np))
    assert want[0] == 1 and want[1] == -1
    got = step._round_half_away(torch.from_numpy(v), TorchXP("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(step._round_half_away(v, np), want)


def _rule_inputs():
    fir = TPGConfig.from_raw("FIR", threshold=5)
    absrs = TPGConfig.from_raw("AbsRS", threshold=150)
    adcs = fir_stream(64, 64, 64, 1, seed=5)
    st = seed_chanstate(init_chanstate(64), adcs[0], 0)
    words = frame_words(adcs)
    return fir, absrs, adcs, st, words, native.relayout_words14(words)


def _rule(case):
    """(call into the JAX package, call into the port) for one rule."""
    fir, absrs, adcs, st, words, W = _rule_inputs()
    pos = jtpg.words14_positions(64)
    j32, j16 = jtpg.pack_state(st, 64), jtpg.pack_state(st, 64,
                                                        dtype=np.int16)
    jpos = jtpg.pack_state(st, 64, positions=pos)
    p32 = tpg.pack_state(st, 64)
    p16 = tpg.pack_state(st, 64, dtype=torch.int16)
    a16 = adcs.astype(np.int16)
    jw = jtpg.process_window_pallas
    pw = tpg.process_window
    cases = {
        "int16-time2": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs_time2(adcs)), j16, fir,
                       tc=32, time_packed=True, unroll=2, interpret=True),
            lambda: pw(torch.from_numpy(time2_words(adcs)), p16, fir, 32, 2,
                       time_packed=True)),
        "int16-words14": (
            lambda: jw(jnp.asarray(W), j16, fir, tc=32, words14=True,
                       interpret=True),
            lambda: pw(torch.from_numpy(W), p16, fir, 32, 2,
                       time_packed=False, packed14="words14")),
        "int16-int32-feed": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(adcs)), j16, fir, tc=32,
                       interpret=True),
            lambda: pw(torch.from_numpy(adcs), p16, fir, 32, 2,
                       time_packed=False)),
        "int32-int16-feed": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(a16, dtype=np.int16)), j32,
                       fir, tc=32, interpret=True),
            lambda: pw(torch.from_numpy(a16), p32, fir, 32, 2,
                       time_packed=False)),
        "int16-twopass": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(a16, dtype=np.int16)), j16,
                       fir, tc=32, interpret=True, fir_twopass=1),
            lambda: pw(torch.from_numpy(a16), p16, fir, 32, 2,
                       time_packed=False, fir_twopass=1)),
        "twopass-not-fir": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(adcs)), j32, absrs, tc=32,
                       interpret=True, fir_twopass=1),
            lambda: pw(torch.from_numpy(adcs), p32, absrs, 32, 2,
                       time_packed=False, fir_twopass=1)),
        "twopass-fir_packed": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(adcs)), j32, fir, tc=32,
                       interpret=True, fir_twopass=2, fir_packed=True),
            lambda: pw(torch.from_numpy(adcs), p32, fir, 32, 2,
                       time_packed=False, fir_twopass=2, fir_packed=True)),
        "twopass-slab": (
            lambda: jingest.process_words14_feed(
                jnp.asarray(W), jpos, fir, 64, tc=32, unroll=2,
                interpret=True, slab=True, fir_twopass=1),
            lambda: ingest.process_words14_feed(
                torch.from_numpy(W), p32, fir, 64, tc=32, slab=True,
                fir_twopass=1)),
        "slab-tc": (
            lambda: jw(jnp.asarray(W), jpos, fir, tc=8, unroll=2,
                       words14=True, words14_slab=True, interpret=True),
            lambda: pw(torch.from_numpy(W), p32, fir, 8, 2,
                       time_packed=False, packed14="words14",
                       words14_slab=True)),
        "slab-not-words14": (
            lambda: jw(jnp.asarray(jtpg.pack_adcs(adcs)), j32, fir, tc=32,
                       unroll=2, words14_slab=True, interpret=True),
            lambda: pw(torch.from_numpy(adcs), p32, fir, 32, 2,
                       time_packed=False, words14_slab=True)),
    }
    return cases[case]


RULES = ["int16-time2", "int16-words14", "int16-int32-feed",
         "int32-int16-feed", "int16-twopass", "twopass-not-fir",
         "twopass-fir_packed", "twopass-slab", "slab-tc",
         "slab-not-words14"]


@pytest.mark.parametrize("case", RULES)
def test_argument_rule_raises_as_in_jax(case):
    jax_call, port_call = _rule(case)
    with pytest.raises((AssertionError, ValueError)):
        jax_call()
    with pytest.raises(ValueError):
        port_call()


@pytest.mark.parametrize("flag", ["words14_gather", "words14_slab"])
def test_schedules_refuse_frame_words(flag):
    """The JAX package has no gather or slab schedule for frame words (its
    fused frame feed relays them to words14 first): the port raises."""
    fir, _, adcs, st, words, _ = _rule_inputs()
    with pytest.raises(ValueError, match="words14"):
        tpg.process_window(torch.from_numpy(words.view(np.int32)),
                           tpg.pack_state(st, 64), fir, 32, 2,
                           time_packed=False, packed14="frames",
                           **{flag: True})


def test_gather_ignored_off_words14():
    """words14_gather on an unpacked feed changes nothing, as in
    ``_decode_ticks``; fir_packed=None is off."""
    fir, _, adcs, st, _, _ = _rule_inputs()
    state = tpg.pack_state(st, 64)
    want = tpg.process_window(torch.from_numpy(adcs), state, fir, 32, 2,
                              time_packed=False)
    got = tpg.process_window(torch.from_numpy(adcs), state, fir, 32, 2,
                             time_packed=False, words14_gather=True,
                             fir_packed=None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
