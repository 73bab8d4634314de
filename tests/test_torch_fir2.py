"""K5, the two-pass FIR schedule, on the CPU: the port's plain version
(``tpg.process_window_twopass_plain``, reached through
``tpg.process_window(..., fir_twopass=1|2)`` on CPU tensors) against the
JAX package's ``_fir2_kernel`` (``process_window_pallas(...,
fir_twopass=1|2, interpret=True)``) and against the port's fused FIR plain
version (K3's), over the variants of ``tests/test_tpg_fir.py::
TestFIRTwoPass``; the tuned ``twopass`` knob read as the JAX package reads
it; ``StreamingIngest(fir_twopass=...)`` and the WIB2 processor under a
tuned file against the JAX package.  Integer pipeline: tolerance 0 on
slots, nclose, state, hits and counters.

The JAX side gets the JAX package's ``TPGConfig``, the port the port's."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops import Algorithm as JAlgorithm
from fdreadoutlibs_tpu.ops import TPGConfig as JTPGConfig
from fdreadoutlibs_tpu.ops import pallas_tpg as jtpg
from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.ingest import StreamingIngest as JaxIngest
from fdreadoutlibs_tpu.ops.ingest import pack_words14_jnp
from fdreadoutlibs_tpu.stream import WIB2FrameProcessor as JWIB2
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu.utils import tuning as jtuning
from fdreadoutlibs_tpu_torch.ops import Algorithm, TPGConfig, tpg
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest, decode_slots
from fdreadoutlibs_tpu_torch.stream import WIB2FrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words)
from fdreadoutlibs_tpu_torch.utils import tuning
from test_torch_stream import _assert_same, _run, _wib2_batches
from test_torch_streaming import drive, wib2_batches
from test_torch_tpg import jax_outputs_to_port

torch.set_num_threads(1)

C, T, TC, K = 128, 128, 64, 2
_FIR = dict(algorithm="FIR", threshold=5, tap_exponent=6)
# the variants of TestFIRTwoPass (tests/test_tpg_fir.py:290-330)
VARIANTS = {
    "nopeaks": dict(_FIR, track_peaks=False),
    "peaks-gated": dict(_FIR, track_peaks=True, peak_gated=True),
    "naive": dict(_FIR, fir_avx_semantics=False),
    "threshold-700": dict(_FIR, threshold=700),     # the wrap-guard branch
}


def port_cfg(jcfg):
    """The port's TPGConfig with the fields of a JAX package's one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["algorithm"] = Algorithm(jcfg.algorithm.value)
    return TPGConfig(**kw)


def configs(name):
    """(the JAX package's config, the port's) for one variant."""
    kw = dict(VARIANTS[name])
    alg = kw.pop("algorithm")
    jcfg = JTPGConfig(algorithm=JAlgorithm(alg), **kw)
    return jcfg, port_cfg(jcfg)


def jax_feed(win, encoding):
    """The window as the JAX kernel takes it, with its state positions."""
    if encoding == "time2":
        return jnp.asarray(jtpg.pack_adcs_time2(win)), {"time_packed": True}
    if encoding == "packed14":
        return (pack_words14_jnp(jnp.asarray(frame_words(win))),
                {"words14": True})
    return jnp.asarray(jtpg.pack_adcs(win)), {}


def port_feed(win, encoding):
    """The window as the port takes it: (feed, time_packed, packed14)."""
    if encoding == "time2":
        return torch.from_numpy(time2_words(win)), True, None
    if encoding == "packed14":
        return torch.from_numpy(frame_words(win).view(np.int32)), False, \
            "frames"
    return torch.from_numpy(np.ascontiguousarray(win)), False, None


@pytest.mark.parametrize("encoding", ["plain", "time2", "packed14"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("fir_twopass", [1, 2])
def test_twopass_plain_matches_pallas_fir2(fir_twopass, variant, encoding):
    """Two windows with the state carried (window carry), four chunks each
    with a K overflow (drops): slots, nclose and state equal JAX
    ``_fir2_kernel``'s and the port's fused plain version's."""
    jcfg, cfg = configs(variant)
    adcs = fir_stream(2 * T, C, TC, K, seed=31)
    st = seed_chanstate(init_chanstate(C), adcs[0], 0)
    pos = jtpg.words14_positions(C) if encoding == "packed14" else None
    stack = jtpg.pack_state(st, C, positions=pos)
    state = fused = tpg.pack_state(st, C)
    max_closes = n_hits = 0
    for w in range(2):
        win = adcs[w * T:(w + 1) * T]
        j_in, j_kw = jax_feed(win, encoding)
        js, jn, stack = jtpg.process_window_pallas(
            j_in, stack, jcfg, tc=TC, k_slots=K, interpret=True,
            unroll=2 if encoding == "time2" else 1, fir_twopass=fir_twopass,
            **j_kw)
        feed, time2, packed14 = port_feed(win, encoding)
        ps, pn, state = tpg.process_window(feed, state, cfg, TC, K, time2,
                                           packed14, fir_twopass=fir_twopass)
        fs, fn, fused = tpg.process_window_plain(feed, fused, cfg, TC, K,
                                                 time2, packed14)
        if pos is None:
            js, jn = jax_outputs_to_port(js, jn, C)
            np.testing.assert_array_equal(ps.numpy(), js)
        else:       # JAX keeps words14 lane positions: compare the hits
            j_hits, j_drop = jtpg.decode_pallas_hits(js, jn, C,
                                                     positions=pos)
            hits, drop = decode_slots(ps, pn, C)
            np.testing.assert_array_equal(hits, j_hits)
            assert drop == j_drop
            jn = np.asarray(jn).transpose(1, 0, 2, 3) \
                .reshape(jn.shape[1], -1)[:, pos]
        np.testing.assert_array_equal(pn.numpy(), jn)
        assert torch.equal(state, tpg.state_from_jax(np.asarray(stack), C,
                                                     positions=pos))
        for g, f in zip((ps, pn, state), (fs, fn, fused)):
            assert torch.equal(g, f)
        max_closes = max(max_closes, int(pn.max()))
        n_hits += int((ps[:, :, -1] != 0).sum())
    assert max_closes > K and n_hits > 0


@pytest.mark.parametrize("fir_twopass", [1, 2])
def test_twopass_plain_ragged_chunks_match_fused(fir_twopass):
    """A chunk that is not a whole number of 16-tick groups and a channel
    count that is no multiple of 32 (K5's blocks): the two-pass plain
    version equals the fused one, state included."""
    cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
    adcs = fir_stream(150, 40, 50, 2, seed=8)
    state = tpg.pack_state(seed_chanstate(init_chanstate(40), adcs[0], 0),
                           40)
    feed = torch.from_numpy(adcs)
    got = tpg.process_window(feed, state, cfg, 50, 2, False,
                             fir_twopass=fir_twopass)
    want = tpg.process_window_plain(feed, state, cfg, 50, 2, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].max()) > 2


def test_twopass_refuses_other_families_and_values():
    """As pallas_tpg.py:867-870: the two-pass schedule is FIR-only."""
    state = torch.zeros((tpg.KSTATE, 16), dtype=torch.int32)
    feed = torch.zeros((32, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="FIR"):
        tpg.process_window(feed, state, TPGConfig(threshold=100), 32, 2,
                           False, fir_twopass=1)
    fir = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
    with pytest.raises(ValueError, match="fir_twopass"):
        tpg.process_window(feed, state, fir, 32, 2, False, fir_twopass=3)
    assert tpg.kernels_of(fir, False, fir_twopass=2) == ("K5",)
    tpg.reset_launches()
    assert tpg.process_window.kernel_launches["K5"] == 0


@pytest.mark.parametrize("tuned", [None, {"FIR": {"twopass": 1}},
                                   {"FIR": {"twopass": 2, "tc": 64}},
                                   {"FIR": {"twopass": "x", "tc": 0}},
                                   {"AbsRS": {"twopass": 2}}],
                         ids=["shipped", "tp1", "tp2-tc", "malformed",
                              "other-family"])
def test_kernel_knobs_match_jax(tuned, tmp_path, monkeypatch):
    """The port's ``kernel_knobs`` reads the tuned file the JAX package
    reads (FDREADOUT_TUNED), with the same per-field fallback: equal tc
    and fir_twopass for every family."""
    if tuned is None:
        monkeypatch.delenv("FDREADOUT_TUNED", raising=False)
    else:
        path = tmp_path / "tuned.json"
        path.write_text(json.dumps(tuned))
        monkeypatch.setenv("FDREADOUT_TUNED", str(path))
    for alg in Algorithm:
        cfg = TPGConfig(algorithm=alg, threshold=5)
        jcfg = JTPGConfig(algorithm=JAlgorithm(alg.value), threshold=5)
        want = jtuning.kernel_knobs(jcfg, 2560)
        got = tuning.kernel_knobs(cfg)
        assert got == {"tc": want["tc"],
                       "fir_twopass": want["fir_twopass"]}, alg


@pytest.mark.parametrize("fir_twopass", [1, 2])
@pytest.mark.parametrize("time2", [False, True], ids=["packed", "time2"])
def test_streaming_ingest_twopass_matches_jax(time2, fir_twopass):
    """``StreamingIngest(format="wib2", fir_twopass=...)`` over three
    pipelined batches equals the JAX class with the same argument."""
    from test_torch_streaming import FIR as JFIR, TC as STC, K as SK
    kw = dict(format="wib2", time2=time2, tc=STC, k_slots=SK,
              fir_twopass=fir_twopass)
    batches = wib2_batches(seed=43)
    port = StreamingIngest(port_cfg(JFIR), 1, device="cpu", **kw)
    ref = JaxIngest(JFIR, 1, interpret=True, **kw)
    assert port.fir_twopass == ref.fir_twopass == fir_twopass
    mode = "wib2-time2" if time2 else "wib2"
    got, want = drive(port, batches, mode), drive(ref, batches, mode)
    for (h, d), (hj, dj) in zip(got, want):
        np.testing.assert_array_equal(h, hj)
        assert d == dj
    assert torch.equal(port.state, tpg.state_from_jax(
        np.asarray(ref.stack), port.n_channels))


@pytest.mark.parametrize("fir_twopass", [1, 2])
def test_wib2_processor_under_twopass_file_matches_jax(fir_twopass, tmp_path,
                                                       monkeypatch):
    """One tuned file selects the two-pass schedule in both packages'
    WIB2 processors (fdreadoutlibs_tpu/stream/wib2.py:151): TPs, counters
    and state equal; on the port the plain version of K5 ran."""
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"FIR": {"twopass": fir_twopass}}))
    monkeypatch.setenv("FDREADOUT_TUNED", str(path))
    seen = []
    real = tpg.process_window_twopass_plain

    def spy(*args, **kw):
        seen.append(args[5] if len(args) > 5 else kw["fir_twopass"])
        return real(*args, **kw)
    monkeypatch.setattr(tpg, "process_window_twopass_plain", spy)
    batches = _wib2_batches()
    conf = {"tpg_algorithm": "FIR", "tpg_threshold": 5}
    _assert_same(_run(WIB2FrameProcessor, QueueSender(), batches, **conf),
                 _run(JWIB2, JQueueSender(), batches, tpg_backend="pallas",
                      tpg_pallas_interpret=True, **conf))
    assert seen == [fir_twopass] * len(batches)
