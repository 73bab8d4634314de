"""K2b: the port's native int16 state mode (the plain version on the CPU,
``fixedpoint.I16Fx`` over ``TorchXP(dtype=torch.int16)``) against the JAX
package's int16 stack in Pallas interpret mode
(``process_window_pallas`` on ``pack_state(dtype=np.int16)``) and against
its ``I16Fx`` tick on numpy.  Integer pipeline: slots, nclose and the
carried state equal bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.fixedpoint import I16Fx as JaxI16Fx
from fdreadoutlibs_tpu.ops.step import dispatch_tick as jax_dispatch_tick
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.step import dispatch_tick
from fdreadoutlibs_tpu_torch.ops.xp import TorchXP, make_fx
from fdreadoutlibs_tpu_torch.testing import fir_stream, tpg_stream
from test_torch_tpg import jax_outputs_to_port

torch.set_num_threads(1)

T, C, TC, K = 256, 200, 64, 2
CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig.from_raw("AbsRS", threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
    TPGConfig.from_raw("FIR", threshold=5),
]
IDS = [c.algorithm.value for c in CONFIGS]


def _stream(cfg, T_, C_, seed):
    if cfg.algorithm == Algorithm.FIR:
        return fir_stream(T_, C_, TC, K, seed), 0
    return tpg_stream(T_, C_, TC, K, seed)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_int16_plain_matches_pallas_across_split(cfg):
    """Two windows of int16 samples through the JAX int16 stack (interpret)
    and the port's int16 state, tc < T so state carries across chunks and
    the split: every output equal, the burst chunk drops hits."""
    adcs, rmf = _stream(cfg, T, C, seed=13)
    stack = jtpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                            C, dtype=np.int16)
    state = tpg.state_from_jax(np.asarray(stack), C)
    assert state.dtype == torch.int16
    half = T // 2
    max_closes = 0
    for w in range(2):
        win = adcs[w * half:(w + 1) * half]
        js, jn, stack = jtpg.process_window_pallas(
            jnp.asarray(jtpg.pack_adcs(win, dtype=np.int16)), stack, cfg,
            tc=TC, k_slots=K, interpret=True)
        ps, pn, state = tpg.process_window(
            torch.from_numpy(win.astype(np.int16)), state, cfg, tc=TC,
            k_slots=K, time_packed=False)
        js, jn = jax_outputs_to_port(js, jn, C)
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pn.numpy(), jn)
        assert state.dtype == torch.int16
        np.testing.assert_array_equal(tpg.state_to_jax(state),
                                      np.asarray(stack))
        max_closes = max(max_closes, int(jn.max()))
    assert max_closes > K


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_int16_equals_int32_in_range(cfg):
    """On 14-bit streams every value stays in int16 range, so K2b's plain
    version gives K2's (K3's) results (tests/test_tpg_int16.py:53-61 says
    where the modes part: a charge driven below -32768)."""
    adcs, rmf = _stream(cfg, T, C, seed=17)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    want = tpg.process_window(torch.from_numpy(adcs), tpg.pack_state(st, C),
                              cfg, TC, K, time_packed=False)
    got = tpg.process_window(torch.from_numpy(adcs.astype(np.int16)),
                             tpg.pack_state(st, C, dtype=torch.int16), cfg,
                             TC, K, time_packed=False)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int32), w)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_i16fx_tick_matches_jax(cfg):
    """The port's I16Fx tick on torch int16 tensors against the JAX
    package's I16Fx tick on numpy int16 arrays, tick by tick, on white
    noise over the whole 14-bit range, where the int16 wraps of I16Fx
    (and not I32Fx's emulation) decide the result."""
    rng = np.random.default_rng(21)
    n = 64
    adcs = rng.integers(0, 1 << 14, size=(96, n)).astype(np.int16)
    st = seed_chanstate(init_chanstate(n), adcs[0], 8 if cfg.algorithm in (
        Algorithm.ABS_RS, Algorithm.STANDARD_RS) else 0)
    st_np = {k: np.asarray(v).astype(np.int16) for k, v in st.items()
             if k != "fir_phase"}
    st_t = {k: torch.from_numpy(v.copy()) for k, v in st_np.items()}
    if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD:
        st_np["rs_memory_factor"] = st_t["rs_memory_factor"] = None
    xp = TorchXP("cpu", torch.int16)
    fx, jfx = make_fx(xp), JaxI16Fx.make(np)
    for t in range(adcs.shape[0]):
        st_np, c_np, r_np = jax_dispatch_tick(st_np, adcs[t], cfg, np,
                                              fx=jfx)
        st_t, c_t, r_t = dispatch_tick(st_t, torch.from_numpy(adcs[t]), cfg,
                                       xp, fx=fx)
        np.testing.assert_array_equal(c_t.numpy(), c_np, err_msg=f"t={t}")
        for f in ("charge", "tover", "peak_adc", "peak_time"):
            assert r_t[f].dtype == torch.int16
            np.testing.assert_array_equal(r_t[f].numpy(), r_np[f],
                                          err_msg=f"{f} t={t}")
        for k, v in st_np.items():
            if v is None:
                continue
            got = st_t[k].numpy() if k != "fir_prev" else \
                np.stack([x.numpy() for x in st_t[k]])
            np.testing.assert_array_equal(got, np.asarray(v),
                                          err_msg=f"{k} t={t}")


@pytest.mark.parametrize("C_,sub", [(200, None), (2100, 16)])
def test_int16_state_converter_round_trip(C_, sub):
    """An int16 JAX stack (16-row sublane granule, blocked at APA scale)
    -> the port's int16 state -> the same stack; ``pack_state`` casts as
    the JAX one does."""
    rng = np.random.default_rng(5)
    st = {k: rng.integers(-40000, 40000, C_).astype(np.int32)
          for k in jtpg._STATE_KEYS}
    st["fir_prev"] = rng.integers(-3000, 3000, (8, C_)).astype(np.int32)
    stack = np.asarray(jtpg.pack_state(st, C_, block_sublanes=sub,
                                       dtype=np.int16))
    assert stack.dtype == np.int16 and stack.shape[2] % 16 == 0
    port = tpg.state_from_jax(stack, C_)
    assert port.dtype == torch.int16
    assert torch.equal(port, tpg.pack_state(st, C_, dtype=torch.int16))
    np.testing.assert_array_equal(tpg.state_to_jax(port, sub), stack)
    back = tpg.unpack_state(port)
    for key, v in jtpg.unpack_state(stack, C_).items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)
