"""The port's probes (``fdreadoutlibs_tpu_torch/probes``) against the JAX
scripts they mirror, on the CPU.  Same numpy-seeded inputs through the JAX
kernel (``pl.pallas_call(..., interpret=True)`` on the functions of
``scripts/``, imported by path: they import jax only inside functions) and
through the port's plain version, which on the card the CUDA kernels are held
to (``tests/test_torch_cuda.py``, ``chip_smoke.py``; their source on the CPU:
``tests/test_torch_kernel_host.py``).  All integer: tolerance 0, bit-equal."""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fdreadoutlibs_tpu_torch import probes
from fdreadoutlibs_tpu_torch.ops import _build
from fdreadoutlibs_tpu_torch.probes import (i16_ops, roofline, slots_ab,
                                            swar_frugal)
from fdreadoutlibs_tpu_torch.utils import preflight

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_roofline = _script("roofline")
jax_i16 = _script("probe_i16_ops")
jax_swar = _script("bench_swar_frugal")


# ---- P1 ---------------------------------------------------------------------

@pytest.mark.parametrize("ilp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows", [8, 24])
def test_issue_plain_matches_jax_probe(monkeypatch, rows, ilp):
    """``probe_issue_rate``'s nested kernel (roofline.py:164-180), run by
    the script itself under a wrapper of ``pl.pallas_call`` that forces
    interpret mode and keeps every output, against ``issue_plain`` on the
    same arange chains at both iteration counts."""
    real, outs = pl.pallas_call, []

    def interpreted(kernel, **kw):
        fn = real(kernel, interpret=True, **kw)

        def run(x):
            outs.append(np.asarray(fn(x)))
            return jnp.asarray(outs[-1])
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    units, iters = 8, (2, 30)
    with jax.disable_jit():
        rate = jax_roofline.probe_issue_rate(rows, ilp, units=units,
                                             iters=iters, trials=1)
    assert rate > 0
    x = roofline.chains_input(ilp, rows * 128, "cpu")
    for n_iters, got in zip(iters, outs[:2]):      # the two warm-up calls
        want = roofline.issue_plain(x, n_iters, units=units)
        np.testing.assert_array_equal(got.reshape(ilp, -1), want.numpy())


def test_issue_entry_runs_plain_on_cpu_and_refuses_mixed_devices():
    x = roofline.chains_input(2, 256, "cpu")
    before = dict(probes.launches)
    out = roofline.issue_chains(x, 3, 2, 128)
    assert torch.equal(out, roofline.issue_plain(x, 3))
    assert probes.launches == before               # the plain path counts 0
    with pytest.raises(ValueError):
        roofline.issue_launch(None, x, 3, 4, 128)  # 512 != 256 elements
    with pytest.raises(ValueError):
        roofline.issue_launch(None, x[:1].repeat(3, 1), 3, 2, 128)  # ilp 3
    with pytest.raises(ValueError):
        probes.require_cuda(x)


def test_summarize_and_bounds():
    """The share of the ceiling and the cycles per tick follow from the
    probe's numbers and one op count per tick."""
    arms = {"tpg_ilp1": {"gops": 1000.0, "cycles_per_dep_op": 5.0},
            "sat": {"gops": 20000.0, "cycles_per_dep_op": 40.0}}
    out = roofline.summarize({"sm_mhz": 2000.0, "arms": arms},
                             {"K2": ("AbsRS", "plain", 1.0),
                              "K4": ("FIR", "packed14", 2.0)}, 8192, 2560)
    assert out["ceiling_gops"] == 20000.0
    k2 = out["kernels"]["K2"]
    assert k2["ops_per_tick"] == 42
    assert k2["gops"] == pytest.approx(8192 * 2560 * 42 / 1e-3 / 1e9)
    assert k2["cycles_per_tick_per_thread"] == pytest.approx(
        1e-3 * 2e9 / 8192)
    assert k2["dep_ops_per_tick_at_probe_latency"] == pytest.approx(
        k2["cycles_per_tick_per_thread"] / 5.0)
    assert out["kernels"]["K4"]["ops_per_tick"] == 70
    # the bound divides by what the card did in the run, never by less
    # than the nominal 132 SMs x 64 lanes x the clock
    assert roofline.ceiling_gops({"arms": arms}) == 20000.0
    assert roofline.bound_ms(132 * 64 * 2e9, 2000.0, 1000.0) == \
        pytest.approx(1e3)
    assert roofline.bound_ms(132 * 64 * 2e9, 2000.0, 2 * 132 * 64 * 2.0) \
        == pytest.approx(500.0)


@pytest.mark.parametrize("name,ilp,blocks,threads", [
    a for a in roofline.ARMS if a[2] * a[3] <= 132 * 128])
def test_check_arm_holds_an_arm_to_plain(name, ilp, blocks, threads):
    """Every arm is checked at its own geometry before it is timed; a
    kernel that differs raises with the error it measured."""
    x = roofline.chains_input(ilp, blocks * threads, "cpu")
    out = roofline.check_arm(x, blocks, threads, n_iters=2)
    assert out["max_abs_err"] == 0 and out["check_iters"] == 2
    assert out["plain_ms"] > 0


def test_check_arm_raises_on_a_wrong_kernel(monkeypatch):
    monkeypatch.setattr(roofline, "issue_chains",
                        lambda x, n, b, t: roofline.issue_plain(x, n) + 3)
    x = roofline.chains_input(2, 256, "cpu")
    with pytest.raises(AssertionError, match="max abs err 3"):
        roofline.check_arm(x, 2, 128, n_iters=1)


def test_max_abs_err_is_measured_in_int64():
    a = torch.tensor([-(1 << 31), 5], dtype=torch.int32)
    b = torch.tensor([(1 << 31) - 1, 5], dtype=torch.int32)
    assert probes.max_abs_err(a, b) == (1 << 32) - 1
    assert probes.max_abs_err((a, b), (a, b)) == 0
    with pytest.raises(AssertionError):
        probes.max_abs_err(a, b.to(torch.int16))


SASS = """
	Function : _ZN7_GLOBAL12issue_kernelILi1EEEvPKiPiii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   LDG.E R5, desc[UR4][R2.64] ;
        /*0050*/                   VIADD R5, R5, 0x9e3779b9 ;
        /*0060*/                   SHF.R.S32.HI R0, RZ, 0x7, R5 ;
        /*0070*/                   LOP3.LUT R5, R0, R5, RZ, 0x3c, !PT ;
        /*0080*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0090*/                   ISETP.NE.AND P0, PT, R4, UR4, PT ;
        /*00a0*/               @P0 BRA 0x50 ;
        /*00b0*/                   STG.E desc[UR4][R2.64], R5 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
	Function : _ZN7_GLOBAL9op_kernelILi19EEEvPKvS1_Pvi
        /*0000*/                   LDG.E.U16 R5, desc[UR4][R2.64] ;
        /*0010*/                   STG.E.U16 desc[UR4][R2.64], R5 ;
        /*0020*/                   EXIT ;
"""


def test_sass_reading():
    """The loop body is what the backward branch closes; control, moves and
    memory are not arithmetic."""
    functions = probes.sass_functions(SASS)
    assert len(functions) == 2
    insns = probes.find_function(functions, "issue_kernel", "ILi1E")
    body = probes.loop_body(insns)
    assert [op for _, op, _ in body][0] == "VIADD"
    assert probes.histogram(body) == {"VIADD": 1, "SHF": 1, "LOP3": 1,
                                      "UIADD3": 1, "ISETP": 1, "BRA": 1}
    assert probes.alu_count(body) == 5          # with the loop's counter
    with pytest.raises(LookupError):
        probes.find_function(functions, "kernel")          # two match
    with pytest.raises(LookupError):
        probes.loop_body(probes.find_function(functions, "op_kernel"))


# ---- P2 ---------------------------------------------------------------------

def _jax_op(name, a, b):
    if name == "narrow_i16":
        fn, out_dt = (lambda a, b, jnp: (a + b).astype(jnp.int16)), jnp.int16
    else:
        fn, out_name = jax_i16.OPS[name]
        out_dt = getattr(jnp, out_name) if out_name else a.dtype

    def kernel(a_ref, b_ref, o_ref):
        o_ref[...] = fn(a_ref[...], b_ref[...], jnp)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(a.shape, out_dt),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))


JAX_OPS = list(jax_i16.OPS) + ["narrow_i16"]


def test_op_names_cover_the_script():
    assert list(i16_ops.OP_NAMES[:len(JAX_OPS)]) == JAX_OPS
    assert set(i16_ops.OP_NAMES[len(JAX_OPS):]) == \
        {"copy", *i16_ops.WORD_OPS}


@pytest.mark.parametrize("seed", [None, 11], ids=["script", "full-range"])
@pytest.mark.parametrize("name", JAX_OPS)
def test_one_op_plain_matches_jax(name, seed):
    """Each ``OPS`` entry (and ``narrow_i16``) as a one-op Pallas kernel in
    interpret mode against the port's plain version: the script's inputs,
    and a draw over the whole int16 range (the wraps agree)."""
    a, b = i16_ops.op_inputs(name, "cpu", seed)
    want = _jax_op(name, a.numpy(), b.numpy())
    got = i16_ops.one_op(name, a, b)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(i16_ops.WORD_OPS))
def test_word_ops_are_per_half_int16(name):
    """The SIMD-in-word ops' plain versions against numpy per-half
    arithmetic."""
    a, b = i16_ops.op_inputs(name, "cpu", 3)
    ah, bh = a.numpy().view(np.int16), b.numpy().view(np.int16)
    ref = {"vadd2": ah + bh, "vsub2": ah - bh,
           "vcmplts2": -(ah < bh).astype(np.int16),
           "vcmpgts2": -(ah > bh).astype(np.int16),
           "vmaxs2": np.maximum(ah, bh), "vmins2": np.minimum(ah, bh),
           "vimax3_s16x2": np.maximum(np.maximum(ah, bh), 0),
           "viaddmax_s16x2": np.maximum(ah + bh, 0)}[name]
    got = i16_ops.one_op(name, a, b)
    np.testing.assert_array_equal(got.numpy().view(np.int16),
                                  ref.astype(np.int16))


@pytest.mark.parametrize("bits", [16, 32])
def test_mix_plain_matches_jax(bits):
    """``_mix_kernel`` in interpret mode against ``mix_plain``; the packed
    arm's words are the int16 chain's elements."""
    n, iters = 2 * 128, 40
    feeds = i16_ops.mix_inputs(n, seed=bits)
    arm = "i16" if bits == 16 else "i32"
    a = feeds[arm].numpy().reshape(i16_ops.N_ARRAYS, 2, 128)
    want = np.asarray(pl.pallas_call(
        functools.partial(jax_i16._mix_kernel, iters=iters, dtype_bits=bits),
        out_shape=jax.ShapeDtypeStruct(a.shape, a.dtype),
        interpret=True)(jnp.asarray(a)))
    got = i16_ops.mix(feeds[arm], iters, arm, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(i16_ops.N_ARRAYS, n))
    if bits == 16:
        packed = i16_ops.mix(feeds["packed"], iters, "packed", 2)
        assert torch.equal(packed.view(torch.int16), got)


# ---- P3 ---------------------------------------------------------------------

def _jax_frugal(kernel, data, m, a, tc):
    out = pl.pallas_call(
        functools.partial(kernel, tc=tc),
        out_shape=[jax.ShapeDtypeStruct(m.shape, jnp.int32)] * 2,
        interpret=True)(jnp.asarray(data), jnp.asarray(m), jnp.asarray(a))
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("seed", [0, 7])
def test_frugal_plain_matches_jax(seed):
    """``_unpacked_kernel`` and ``_packed_kernel`` in interpret mode, on
    the script's tile layout (channel pairs are tile rows 2i and 2i + 1),
    against the port's plain versions on its own layout (channels 2i and
    2i + 1): the same per-channel medians and accumulators after
    un-biasing, which also equal the unpacked chain's."""
    T, S = 96, 4                                   # 512 channels
    C = S * 128
    adcs = swar_frugal.make_adcs(T, C, seed)
    adcs[T // 2:, ::3] += 40                       # medians must move
    up = adcs.reshape(T, S, 128)
    BA, BC = jax_swar._BA, jax_swar._BC
    assert (BA, BC, jax_swar.LIMIT) == (swar_frugal.BA, swar_frugal.BC,
                                        swar_frugal.LIMIT)
    m0 = np.full((S, 128), 900, np.int32)
    a0 = np.zeros((S, 128), np.int32)
    mu, au = _jax_frugal(jax_swar._unpacked_kernel, up, m0, a0, T)
    pk = (up[:, 0::2] + BA) | ((up[:, 1::2] + BA) << 16)
    m0p = np.full((S // 2, 128), (900 + BA) | ((900 + BA) << 16), np.int32)
    a0p = np.full((S // 2, 128), BC | (BC << 16), np.int32)
    mp, ap = _jax_frugal(jax_swar._packed_kernel, pk, m0p, a0p, T)
    np.testing.assert_array_equal(mu[0::2], (mp & 0xFFFF) - BA)
    np.testing.assert_array_equal(au[1::2], ((ap >> 16) & 0xFFFF) - BC)

    inputs = swar_frugal.arm_inputs(adcs, "cpu")
    got_m, got_a = swar_frugal.frugal(*inputs["unpacked"], "unpacked")
    np.testing.assert_array_equal(got_m.numpy(), mu.reshape(C))
    np.testing.assert_array_equal(got_a.numpy(), au.reshape(C))
    assert (got_m != 900).any()
    pm, pa = swar_frugal.frugal(*inputs["packed"], "packed")
    assert torch.equal(swar_frugal.unpack_pairs(pm, BA), got_m)
    assert torch.equal(swar_frugal.unpack_pairs(pa, BC), got_a)
    # the packed words themselves, where the two layouts pair the same
    # channels: feed the port the script's pairing
    x = torch.from_numpy(np.ascontiguousarray(pk.reshape(T, C // 2)))
    jm, ja = swar_frugal.packed_plain(x, torch.from_numpy(m0p.reshape(-1)),
                                      torch.from_numpy(a0p.reshape(-1)))
    np.testing.assert_array_equal(jm.numpy(), mp.reshape(-1))
    np.testing.assert_array_equal(ja.numpy(), ap.reshape(-1))
    swar_frugal.check_parity(inputs)


def test_pack_pairs_round_trip():
    x = torch.arange(-50, 50, dtype=torch.int32).reshape(2, 50)
    w = swar_frugal.pack_pairs(x, swar_frugal.BA)
    assert w.shape == (2, 25)
    assert torch.equal(swar_frugal.unpack_pairs(w, swar_frugal.BA), x)


# ---- the entries' control flow, preflight, the build keys -------------------

def test_slots_ab_rehearsal_on_cpu():
    """``slots_ab.run`` on a CPU device: every case of ``--datapaths all``
    runs the plain version in both arms and the parity holds; the flag is
    restored; no time is reported."""
    from fdreadoutlibs_tpu_torch.ops import tpg
    out = slots_ab.run("cpu", C=64, T=256, datapaths="all",
                       families=("AbsRS", "FIR"))
    assert tpg.SLOT_WORD_CARRY is False
    assert set(out) == {"AbsRS plain", "FIR plain", "AbsRS time2",
                        "AbsRS frames", "AbsRS words14",
                        "AbsRS words14 gather", "AbsRS words14 slab",
                        "AbsRS int16", "FIR plain fir_packed"}
    for res in out.values():
        assert res["hits"] > 0 and set(res) == {"hits", "dropped"}
    json.dumps(out)
    assert [c[0] for c in slots_ab.cases()] == [
        f"{f} plain" for f in slots_ab.FAMILIES]
    with pytest.raises(ValueError):
        slots_ab.cases("some")


def test_preflight():
    info = preflight.device_preflight("cpu")
    assert info["ok"] and info["torch"] == torch.__version__
    if not torch.cuda.is_available():
        bad = preflight.device_preflight(raise_on_error=False)
        assert bad["ok"] is False and "torch" in bad["error"]
        with pytest.raises(RuntimeError, match="versions"):
            preflight.device_preflight()


def test_library_keys_are_per_library(tmp_path, monkeypatch):
    """A probe source is no part of the tpg library's key (and the other
    way round); a header is part of the key of the units that include
    it, the C entries' shared ``device_scope.cuh`` of both."""
    tpg_src = {p.name for p in _build.sources("tpg")}
    probe_src = {p.name for p in _build.sources("probes")}
    assert "tpg.cuh" in tpg_src and "probes.cuh" in probe_src
    assert tpg_src & probe_src == {"device_scope.cuh"}
    assert {"tpg_carry_plain.cu", "tpg_plain.cu", "tpg.cu"} <= tpg_src
    assert {"probes_issue.cu", "probes_i16.cu",
            "probes_swar.cu"} == probe_src - {"probes.cuh",
                                              "device_scope.cuh"}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC_DIR.glob("*.cu*"):
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n).name for n in ("tpg", "probes")}
    with open(csrc / "probes_swar.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("tpg").name == before["tpg"]
    assert _build.library_path("probes").name != before["probes"]
    with open(csrc / "tpg.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("tpg").name != before["tpg"]
    edited = {n: _build.library_path(n).name for n in ("tpg", "probes")}
    with open(csrc / "device_scope.cuh", "a") as f:
        f.write("// edited\n")
    assert all(_build.library_path(n).name != edited[n]
               for n in ("tpg", "probes"))
