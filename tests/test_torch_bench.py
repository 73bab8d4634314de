"""The port's bench (``fdreadoutlibs_tpu_torch/bench/``) against the JAX
package's ``bench.py`` and ``scripts/bench_*.py`` on the CPU, at small
sizes: the data generators give the same bytes for the same seed, the
production variants' words encoding is ``bench.py``'s, each production
variant's entry gives the slots, nclose and state of
``process_window_pallas(interpret=True)`` on the same ADCs, the app
projection gives the same numbers, the host TP path and codec stages give
the same counts and bytes, the CPU smoke line carries ``bench.py``'s keys,
a cell that raises makes the bench exit non-zero, and so does a run with no
card and no ``--device cpu``.  The JAX scripts are imported by path (they
import jax only inside functions, or the JAX package on the CPU)."""

import ast
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import native as jax_native
from fdreadoutlibs_tpu.formats import wibeth as jax_wibeth
from fdreadoutlibs_tpu.ops import TPGConfig as JaxTPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu_torch import bench, native
from fdreadoutlibs_tpu_torch.bench import (app_rtf, frontends, host_codec,
                                           latency, tp_path)
from fdreadoutlibs_tpu_torch.ops import tpg
from test_torch_tpg import jax_outputs_to_port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_main():
    """``bench.py``'s ``main`` as an AST node (the file runs nothing when
    parsed)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return {n.name: n for n in tree.body
            if isinstance(n, ast.FunctionDef)}


def _exec_lines(first: str, last: str, ns: dict) -> dict:
    """Run the lines of ``bench.py`` from the one starting with ``first``
    to the one starting with ``last`` (dedented) in ``ns``."""
    lines = (ROOT / "bench.py").read_text().splitlines()
    i = next(j for j, l in enumerate(lines) if l.strip().startswith(first))
    k = next(j for j in range(i, len(lines))
             if lines[j].strip().startswith(last))
    exec(textwrap.dedent("\n".join(lines[i:k + 1])), ns)
    return ns


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the run with no card")


# ---- the data ---------------------------------------------------------------

def test_data_generators_match_jax():
    """bench.py:467-472 (run from its own lines), ``bench_app_rtf.
    generate_batches``, ``bench_latency.gen_batch`` and ``bench_frontends.
    _noise_pulses`` give the same bytes as the port's for the same seed."""
    T, C = 512, 256
    ns = _exec_lines("rng = np.random.default_rng(0)",
                     "adcs[t0:t0 + 8, c] += rng.integers(300, 3000)",
                     {"np": np, "T": T, "C": C})
    np.testing.assert_array_equal(bench.make_adcs(T, C), ns["adcs"])
    ja = _script("bench_app_rtf")
    for want, got in zip(ja.generate_batches(2, 3, 2, 0.05, seed=4),
                         app_rtf.generate_batches(2, 3, 2, 0.05, seed=4)):
        np.testing.assert_array_equal(got, want)
    jl = _script("bench_latency")
    want = jl.gen_batch(np.random.default_rng(5), 3, 2, 1, 0x1000000, 0.5)
    got = latency.gen_batch(np.random.default_rng(5), 3, 2, 1, 0x1000000,
                            0.5)
    np.testing.assert_array_equal(got, want)
    jf = _script("bench_frontends")
    for kw in ({"seed": 11}, {"seed": 19, "sigma": 8, "base": 8000,
                              "n_sig": 60, "amp_lo": 100, "amp_hi": 1500}):
        np.testing.assert_array_equal(frontends._noise_pulses(512, 40, **kw),
                                      jf._noise_pulses(512, 40, **kw))
    assert frontends.TICK_HZ == jf.TICK_HZ
    assert latency.ARM_KWARGS.keys() == jl.ARM_KWARGS.keys()


def test_words_encoding_matches_jax():
    """The production variants' frame words are ``bench.py``'s ``to_words``
    (run from its own source) byte for byte, and the variants' rolls are
    its rolls (the counterpart of ``tests/test_ingest.py::
    test_bench_ingest_encoding_roundtrip``; the entries' hits are held in
    :func:`test_production_variants_match_pallas`)."""
    T, C = 256, 128
    fn = _bench_py_main()["bench_fresh_and_ingest"]
    to_words = next(n for n in ast.walk(fn)
                    if isinstance(n, ast.FunctionDef)
                    and n.name == "to_words")
    ns = {"np": np, "wibeth": jax_wibeth, "T": T, "L": C // 64,
          "n_frames": T // 64}
    exec(compile(ast.Module([to_words], []), "bench.py", "exec"), ns)
    adcs = bench.make_adcs(T, C, seed=3)
    np.testing.assert_array_equal(bench.to_words(adcs), ns["to_words"](adcs))
    rng = np.random.default_rng(42)
    want = [adcs] + [np.roll(adcs, rng.integers(1, T), axis=0)
                     for _ in range(3)]
    for g, w in zip(bench.stream_variants(adcs), want):
        np.testing.assert_array_equal(g, w)


def test_production_variants_match_pallas():
    """At C = 256, T = 512 each production variant's first window, through
    its entry on the CPU (the plain versions), gives the slots, nclose and
    state of the JAX kernel in interpret mode on the same ADCs (the
    words14 variants' state canonical, the JAX kernel's plain-sample
    datapath); ``bench_fresh_and_ingest`` then times all six with no
    error."""
    T, C, TC, K = 512, 256, 128, 2
    cfg = JaxTPGConfig.from_raw("AbsRS", threshold=150)
    pcfg = bench.configs()["AbsRS_production"]
    adcs = bench.make_adcs(T, C, seed=7)
    rmf = bench.mixed_rmf(pcfg, C)
    st = seed_chanstate(init_chanstate(C), adcs[0], rmf)
    js, jn, jstate = jtpg.process_window_pallas(
        jnp.asarray(jtpg.pack_adcs(adcs)), jtpg.pack_state(st, C), cfg,
        tc=TC, k_slots=K, interpret=True)
    js, jn = jax_outputs_to_port(js, jn, C)
    jstate = tpg.state_from_jax(np.asarray(jstate), C)
    assert int(jn.max()) > K                      # drops exercised
    inputs = bench.variant_inputs([adcs], "cpu")
    state0 = bench.seeded_state(adcs, rmf, "cpu")
    for name in bench.VARIANTS:
        slots, nclose, state = bench.variant_step(name, pcfg, C, TC, K)(
            inputs[name][0], state0)
        np.testing.assert_array_equal(slots.numpy(), js, err_msg=name)
        np.testing.assert_array_equal(nclose.numpy(), jn, err_msg=name)
        assert torch.equal(state, jstate), name
    out, parity = bench.bench_fresh_and_ingest(
        pcfg, TC, K, adcs[:2 * TC, :128], rmf[:128], n_windows=1, trials=1,
        n_distinct=2, device="cpu")
    assert sorted(out) == sorted(bench.VARIANTS) and parity == {}


def test_projection_matches_jax():
    """``projection`` gives the JAX script's numbers for the same inputs
    (its ``assumes`` text names the card's timing)."""
    ja = _script("bench_app_rtf")
    unpiped = {"stages_ms_p50": {"preprocess_ms": 1.25, "retention_ms": 0.5,
                                 "codec_ms": 6.75, "device_ms": 3.0,
                                 "assembly_ms": 2.0, "handler_ms": 0.875}}
    for dev_ms, mb in ((0.9, 42.0), (5.0, 12.5)):
        want = ja.projection(4.194304, unpiped, dev_ms, mb, 16.0)
        got = app_rtf.projection(4.194304, unpiped, dev_ms, mb, 16.0)
        want.pop("assumes"), got.pop("assumes")
        assert got == want


def test_tp_path_and_codecs_match_jax():
    """The TP-path stages at ``tests/test_tp_handler.py::
    test_bench_tp_path_smoke``'s tiny sizes give the JAX script's counts on
    the same seeded data (the records byte for byte, the TPSets emitted,
    the keys), and the codec cases feed the JAX package's native codecs'
    bytes."""
    jt = _script("bench_tp_path")
    for make in ("make_hits", "make_tps"):
        got = getattr(tp_path, make)(50, np.random.default_rng(2))
        want = getattr(jt, make)(50, np.random.default_rng(2))
        assert got.dtype.descr == want.dtype.descr
        assert got.tobytes() == want.tobytes(), make
    sizes = {"bench_latency_buffer": (4, 64), "bench_wib_tp_handler": (4, 32),
             "bench_request_handler": (8, 32)}
    for fn, (n, b) in sizes.items():
        got = getattr(tp_path, fn)(1, np.random.default_rng(3), n, b)
        want = getattr(jt, fn)(1, np.random.default_rng(3), n, b)
        assert got.keys() == want.keys(), fn
        if fn == "bench_request_handler":
            for impl in want:
                assert got[impl]["tpsets_emitted"] == \
                    want[impl]["tpsets_emitted"] > 0
    loop = tp_path.bench_apa_host_loop(1, np.random.default_rng(3),
                                       n_batches=3, links=4, frames=2)
    assert loop["batches_per_s"] > 0 and loop["links"] == 4
    # bench.py's codec words (:367-376), through the JAX package's codecs
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, size=(2, 64, 28), dtype=np.uint32)
    w2 = rng.integers(0, 2 ** 32, size=(10, 64, 112), dtype=np.uint32)
    # the port's own case: the same relayout read from random frames
    frames = rng.integers(0, 256, size=(2, 1, 7200), dtype=np.uint8)
    fwords = jax_wibeth.frames_bytes_to_u32(frames).reshape(2, 64, 28)
    want = {"time2": (words, jax_native.relayout_time2(words)),
            "time2_frames": (fwords, jax_native.relayout_time2(fwords)),
            "words14": (words, jax_native.relayout_words14(words)),
            "time2_wib2": (w2, jax_native.relayout_time2(w2,
                                                         ch_per_link=256))}
    cases = host_codec.codec_cases(L=2, T=64, seed=1)
    assert [c[0] for c in cases] == list(want)
    for name, nbytes, fn in cases:
        assert nbytes == want[name][0].nbytes, name
        np.testing.assert_array_equal(fn(native.FeedBuffer()), want[name][1],
                                      err_msg=name)


def test_card_cells_run_on_the_cpu_at_a_tiny_size():
    """The cells the bench runs only on the card, through the same entries
    on the CPU (the plain versions) at a tiny size: the latency cell on
    every feed of ``ARM_KWARGS`` (the time2 feed's keys at the top, the
    others under ``feeds``, each closing hits), each frontend arm (its
    hit check; no trace without a card), and the app's transfer, timed in
    the run, is the one ``projection`` reads."""
    lat = latency.bench_latency("cpu", batches=1, warmup=1, links=2,
                                frames_n=8)
    assert set(latency.KEYS) <= set(lat) and lat["total_hits"] > 0
    assert set(lat["feeds"]) == set(latency.ARM_KWARGS) - {"time2"}
    assert all(f["total_hits"] > 0 for f in lat["feeds"].values())
    for name, arm in frontends.ARMS.items():
        cell = arm(256, 1, 1, torch.device("cpu"), links=2)
        # its times are the CPU's (rounded, they may read 0)
        assert cell["tick_hz"] == frontends.TICK_HZ[name], name
        assert len(cell["trials"]) == 1 and cell.get("trace") is None, name
    ms = app_rtf.measure_transfer_ms(2, 8, trials=1, device="cpu")
    unpiped = {"stages_ms_p50": {"preprocess_ms": 1.0, "retention_ms": 0.5,
                                 "codec_ms": 2.0, "assembly_ms": 1.0,
                                 "handler_ms": 0.5}}
    proj = app_rtf.projection(0.262144, unpiped, 1e-3, 0.75, 0.75 / ms)
    assert ms > 0 and proj["stage_ms"]["transfer_ms"] == round(ms, 3)


# ---- the line ---------------------------------------------------------------

def test_cpu_smoke_line_has_bench_keys():
    """``run("cpu")`` is bench.py's smoke shape: its line carries every
    key that bench.py's ``main`` writes on a CPU run (those before the
    device cells), the four families, no error, and a null parity (no
    kernel ran); ``KEYS`` is exactly the keys bench.py's ``main`` writes,
    its error keys aside."""
    main = _bench_py_main()["main"]
    written = set()
    for n in ast.walk(main):
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name) \
                and n.targets[0].id == "out" and isinstance(n.value,
                                                            ast.Dict):
            written |= {k.value for k in n.value.keys
                        if isinstance(k, ast.Constant)}
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id == "out" and isinstance(n.ctx, ast.Store) \
                and isinstance(n.slice, ast.Constant):
            written.add(n.slice.value)
    assert {k for k in written if not k.endswith("_error")} == \
        set(bench.KEYS)
    line = bench.run("cpu", trials=1, seconds=0.05)
    json.dumps(line)
    assert set(bench.KEYS[:10]) <= set(line)
    assert set(line["algorithms"]) == set(bench.configs())
    assert line["metric"] == bench.METRIC and line["parity"] is None
    assert bench.failures(line) == []
    assert line["host_tp_path"]["latency_buffer_insert_tps_per_s"] > 0


def test_a_failing_cell_makes_the_bench_exit_nonzero(monkeypatch, capsys):
    """A cell that raises keeps its ``*_error`` key in the line beside the
    other cells' numbers, and the bench exits 1 (at 256 channels: the exit
    code is the point)."""
    monkeypatch.setattr(bench, "C_APA", 256)

    def boom(*args, **kw):
        raise RuntimeError("cell failed")
    monkeypatch.setattr(host_codec, "bench_host_codecs", boom)
    monkeypatch.setattr(tp_path, "bench_host_tp_path", boom)
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cell failed" in line["host_codecs_error"]
    assert "host_tp_path_error" in line and "algorithms" in line


def test_no_card_exits_nonzero(no_card):
    """With no card and no ``--device cpu`` the bench prints an error line
    and exits non-zero."""
    res = subprocess.run(
        [sys.executable, "-m", "fdreadoutlibs_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and "CUDA" in line["error"]
