"""The port's ProtoWIB frontend against the JAX package on the CPU: the
12-bit codec and its tables, the dual-plane ``WIBFrameProcessor`` (hits,
TPs, TPSets of the legacy ``WIBTPHandler``, forwarded errored frames and
counters) on the reference and pallas backends, both feeds (packed device
decode, time2 host codec) and the three FIR schedules of one tuned file
(``FDREADOUT_TUNED``: twopass 0, 1, 2), and ``models.run_model`` on its
three backends.  Integer pipeline: exact equality.

Batches are 96 ticks, so the JAX processor's interpret-mode chunk cap (512,
protowib.py:258, :305) and the port's knob (256) both give tc = 96 and
the two packages drop the same hits."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.formats import protowib as jprotowib
from fdreadoutlibs_tpu.models import run_model as jrun_model
from fdreadoutlibs_tpu.ops import Algorithm as JAlgorithm
from fdreadoutlibs_tpu.ops import TPGConfig as JTPGConfig
from fdreadoutlibs_tpu.stream.protowib import WIBFrameProcessor as JWIB
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu.tp.wib_tp_handler import WIBTPHandler as JHandler
from fdreadoutlibs_tpu_torch.formats import protowib
from fdreadoutlibs_tpu_torch.models import MODEL_FAMILIES, get_model, \
    run_model
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.chanstate import FIELDS
from fdreadoutlibs_tpu_torch.stream import WIBFrameProcessor
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.testing import fir_stream, protowib_superchunks
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
from test_torch_fir2 import port_cfg

torch.set_num_threads(1)

COUNTERS = ("num_hits", "num_hits_dropped", "num_tps_sent", "num_ts_errors",
            "num_frame_errors", "num_frame_errors_bit0",
            "num_frame_errors_bit2", "num_tps_suppressed_too_long")


# ---- the format ------------------------------------------------------------

def test_tables_and_helpers_match_jax():
    for name in ("COLLECTION_INDEX_TO_CHAN", "INDUCTION_INDEX_TO_CHAN",
                 "COLLECTION_OFFLINES", "INDUCTION_OFFLINES",
                 "COLLECTION_CHANNEL_MASK"):
        np.testing.assert_array_equal(getattr(protowib, name),
                                      getattr(jprotowib, name), err_msg=name)
    for a, b in zip(protowib.register_offline_channels(100, 200),
                    jprotowib.register_offline_channels(100, 200)):
        np.testing.assert_array_equal(a, b)
    sc, adcs = protowib_superchunks(1, 2, seed=4)
    frames = protowib.superchunk_frames(sc[0]).reshape(-1,
                                                       protowib.FRAME_SIZE)
    np.testing.assert_array_equal(protowib.get_adcs(frames), adcs[0])
    np.testing.assert_array_equal(protowib.get_adcs(frames),
                                  jprotowib.get_adcs(frames))
    np.testing.assert_array_equal(protowib.get_timestamp(frames),
                                  jprotowib.get_timestamp(frames))
    np.testing.assert_array_equal(protowib.frames_bytes_to_u32(frames),
                                  jprotowib.frames_bytes_to_u32(frames))
    protowib.fake_frame_errors(sc[0], 0b1001)
    np.testing.assert_array_equal(protowib.get_wib_errors(frames),
                                  jprotowib.get_wib_errors(frames))
    assert (protowib.get_wib_errors(frames) == 0b1001).all()


def test_torch_unpack_matches_jnp_and_host():
    """The torch decode of whole-frame words == ``unpack_frames_jnp`` ==
    the host ``get_adcs``, for every 12-bit value pattern."""
    rng = np.random.default_rng(9)
    frames = np.zeros((24, protowib.FRAME_SIZE), np.uint8)
    adcs = rng.integers(0, 1 << 12, size=(24, 256), dtype=np.uint16)
    protowib.set_adcs(frames, adcs)
    words = protowib.frames_bytes_to_u32(frames)
    got = protowib.unpack_frames(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (24, 256)
    np.testing.assert_array_equal(got.numpy(), adcs.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jprotowib.unpack_frames_jnp(jnp.asarray(words))))


@pytest.mark.parametrize("pad8", [False, True])
def test_native_time2_codec_matches_jax(pad8, monkeypatch):
    """The port's own native library (built from its copy of
    framecodec.cpp into fdreadoutlibs_tpu_torch/_build/) and its numpy
    fallback relayout ProtoWIB frames as the JAX package's native does
    (which always pads to 8 rows of 128 lanes)."""
    from fdreadoutlibs_tpu import native as jnative
    from fdreadoutlibs_tpu_torch import native
    assert native.available()
    rng = np.random.default_rng(5)
    frames = protowib.empty_frames(24)
    protowib.set_adcs(frames, rng.integers(0, 1 << 12, size=(24, 256),
                                           dtype=np.uint16))
    for chan in (protowib.COLLECTION_INDEX_TO_CHAN,
                 protowib.INDUCTION_INDEX_TO_CHAN):
        want = jnative.relayout_time2_protowib(frames, chan)
        if not pad8:        # only the rows that hold channels
            want = want[:, :-(-len(chan) // 128)]
        np.testing.assert_array_equal(
            native.relayout_time2_protowib(frames, chan, pad8=pad8), want)
        with monkeypatch.context() as m:
            m.setattr(native, "load", lambda: None)
            np.testing.assert_array_equal(
                native.relayout_time2_protowib(frames, chan, pad8=pad8), want)


# ---- the processor ---------------------------------------------------------

def _batches():
    """Two 96-tick batches of one link: a collection and an induction pulse
    straddle the batch boundary, one collection channel closes four hits
    in the first batch (drops at K = 2), a timestamp gap opens in the
    second batch and one superchunk carries WIB error bits 0 and 2."""
    sc, adcs = protowib_superchunks(1, 16, seed=17)
    adcs = adcs[0]
    c, i = (int(protowib.COLLECTION_INDEX_TO_CHAN[11]),
            int(protowib.INDUCTION_INDEX_TO_CHAN[30]))
    adcs[88:104, c] += 2500
    adcs[90:100, i] += 1500
    burst = int(protowib.COLLECTION_INDEX_TO_CHAN[40])
    for j in range(4):
        adcs[4 + 20 * j:7 + 20 * j, burst] += 3000
    adcs = np.clip(adcs, 0, (1 << protowib.ADC_BITS) - 1)
    sc = sc[0]
    frames = protowib.superchunk_frames(sc)
    protowib.set_adcs(frames, adcs.reshape(16, 12, 256))
    protowib.fake_timestamps(sc, 50_000)
    flat = frames.reshape(-1, protowib.FRAME_SIZE)
    gap = 11 * protowib.FRAMES_PER_SUPERCHUNK     # superchunk 11 on: +300
    protowib.set_timestamp(flat[gap:], protowib.get_timestamp(flat[gap:])
                           + protowib.SUPERCHUNK_TICK_DIFFERENCE)
    protowib.fake_frame_errors(sc[3:4], 0b101)
    return [sc[:8], sc[8:]]


def _run(cls, handler_cls, sender_cls, batches, **conf):
    """Drive one processor; returns (hits per call, TPs, TPSets, forwarded
    errored frames, counters)."""
    tp_q, set_q, err_q = sender_cls(), sender_cls(), sender_cls()
    handler = handler_cls(tp_sink=tp_q, tpset_sink=set_q, tp_timeout=2_000,
                          tpset_window_size=500, source_id=3)
    kw = dict(tp_handler=handler, errored_frame_sink=err_q)
    p = cls(**kw) if cls is JWIB else cls(device="cpu", **kw)
    p.conf({"crate_id": 1, "slot_id": 0, "link_id": 3, "enable_tpg": True,
            "tpg_k_slots": 2, "tpg_pallas_interpret": True,
            "tpg_induction_threshold": 4, **conf})
    p.start()
    hits = []
    emit = p._emit_tps

    def recording(h, offlines, timestamp, current):
        hits.append(np.array(h, copy=True))
        return emit(h, offlines, timestamp, current)
    p._emit_tps = recording
    for b in batches:
        p.process(b.copy())
    while handler.try_sending_tpsets(10**12) is not None:
        pass
    tps = tp_q.drain()
    sets = [(s.start_time, s.end_time, s.seqno, s.origin, s.objects)
            for s in set_q.drain()]
    return (hits, np.concatenate(tps) if tps else np.zeros(0), sets,
            err_q.drain(), {k: p.metrics.count(k) for k in COUNTERS})


CASES = [("reference", False, 0), ("scan", False, 0)] + [
    ("pallas", time2, tp) for time2 in (False, True) for tp in (0, 1, 2)]


@pytest.mark.parametrize(
    "backend,time2,twopass", CASES,
    ids=[f"{b}-{'time2' if t else 'packed'}-twopass{tp}"
         for b, t, tp in CASES])
def test_processor_matches_jax(backend, time2, twopass, tmp_path,
                               monkeypatch):
    """One tuned file selects the FIR schedule in both packages; the port
    runs the schedule it names (the plain version of K5 for twopass 1 and
    2, once per plane per batch)."""
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"FIR": {"twopass": twopass}}))
    monkeypatch.setenv("FDREADOUT_TUNED", str(path))
    seen = []
    real = tpg.process_window_twopass_plain

    def spy(*args, **kw):
        seen.append(args[5])
        return real(*args, **kw)
    monkeypatch.setattr(tpg, "process_window_twopass_plain", spy)
    batches = _batches()
    conf = {"tpg_time2_feed": time2}
    got = _run(WIBFrameProcessor, WIBTPHandler, QueueSender, batches,
               tpg_backend=backend, **conf)
    want = _run(JWIB, JHandler, JQueueSender, batches,
                tpg_backend=backend, **conf)
    hits, tps, sets, errs, counts = got
    j_hits, j_tps, j_sets, j_errs, j_counts = want
    assert len(hits) == len(j_hits) == 4          # 2 planes x 2 batches
    for h, jh in zip(hits, j_hits):
        np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(tps, j_tps)
    assert len(sets) == len(j_sets) > 1
    for s, js in zip(sets, j_sets):
        assert s[:4] == js[:4]
        np.testing.assert_array_equal(s[4], js[4])
    assert len(errs) == len(j_errs) == 1
    np.testing.assert_array_equal(errs[0], j_errs[0])
    assert counts == j_counts
    assert counts["num_hits"] > 0 and counts["num_tps_sent"] > 0
    assert counts["num_ts_errors"] == 1 and counts["num_frame_errors"] == 24
    if backend == "pallas":
        assert counts["num_hits_dropped"] > 0
    assert seen == ([twopass] * 4 if backend == "pallas" and twopass else [])


def test_processor_backends_agree_and_refuse_unknown():
    """The port's three backends give one TP stream on data without drops;
    an unknown backend is refused at conf time."""
    sc, _ = protowib_superchunks(1, 16, seed=3)
    out = {}
    for backend in ("reference", "scan", "pallas"):
        _, tps, _, _, counts = _run(WIBFrameProcessor, WIBTPHandler,
                                    QueueSender, [sc[0, :8], sc[0, 8:]],
                                    tpg_backend=backend, tpg_k_slots=8)
        out[backend] = tps
        assert counts["num_hits_dropped"] == 0
    assert len(out["reference"]) > 0
    for backend in ("scan", "pallas"):
        np.testing.assert_array_equal(out[backend], out["reference"])
    p = WIBFrameProcessor(device="cpu")
    assert p.backend == "pallas"
    with pytest.raises(ValueError):
        p.conf({"tpg_backend": "dense"})


# ---- run_model ---------------------------------------------------------------

# the tuned schedule reaches only the FIR windows of "pallas"
RUN_MODEL_CASES = [(a, b, 0) for a in ("FIR", "AbsRS")
                   for b in ("reference", "scan", "pallas")] + \
    [("FIR", "pallas", 1), ("FIR", "pallas", 2)]


@pytest.mark.parametrize("algorithm,backend,twopass", RUN_MODEL_CASES)
def test_run_model_matches_jax(algorithm, backend, twopass, tmp_path,
                               monkeypatch):
    """600 ticks x 32 channels (two 'pallas' windows, 512 + 88): hits and
    the returned state equal the JAX package's ``run_model`` on the same
    backend, under a tuned file naming ``twopass``."""
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"FIR": {"twopass": twopass}}))
    monkeypatch.setenv("FDREADOUT_TUNED", str(path))
    threshold = 5 if algorithm == "FIR" else 150
    jcfg = JTPGConfig(algorithm=JAlgorithm(algorithm), threshold=threshold,
                      track_peaks=algorithm != "FIR")
    cfg = port_cfg(jcfg)
    adcs = fir_stream(600, 32, 64, 2, seed=23)
    rmf = 0 if algorithm == "FIR" else 8
    hits, st = run_model(adcs, cfg, backend, rs_memory_factor=rmf,
                         device="cpu")
    j_hits, j_st = jrun_model(adcs, jcfg, backend, rs_memory_factor=rmf)
    assert len(hits) > 8
    np.testing.assert_array_equal(hits, j_hits)
    for key in FIELDS + ("rs_memory_factor", "fir_prev"):
        if key in j_st:
            np.testing.assert_array_equal(st[key], np.asarray(j_st[key]),
                                          err_msg=key)


def test_model_registry_matches_jax():
    from fdreadoutlibs_tpu.models import MODEL_FAMILIES as JFAMILIES
    from fdreadoutlibs_tpu.stream.errors import TPGAlgorithmInexistent as JE
    from fdreadoutlibs_tpu_torch.stream.errors import TPGAlgorithmInexistent
    assert list(MODEL_FAMILIES) == list(JFAMILIES)
    for name, fam in MODEL_FAMILIES.items():
        j = JFAMILIES[name]
        assert (fam.algorithm.value, int(fam.tp_algorithm), fam.uses_rs_state,
                fam.uses_fir_state, fam.dynamic_threshold) == \
            (j.algorithm.value, int(j.tp_algorithm), j.uses_rs_state,
             j.uses_fir_state, j.dynamic_threshold)
        assert get_model(name) is fam
    with pytest.raises(TPGAlgorithmInexistent):
        get_model("Dense")
    assert JE is not TPGAlgorithmInexistent
    with pytest.raises(ValueError):
        run_model(np.zeros((8, 4), np.int32), port_cfg(JTPGConfig()),
                  "dense", device="cpu")


def test_chip_smoke_oracle_matches_jax_processors():
    """chip_smoke.py holds the ProtoWIB processors on the card against the
    kernel's plain version over each plane's channels of all links, with
    the processors' seeding, tc, K and per-link compaction; here that
    oracle is held against the JAX processors' hits on the same frames (two
    links, two 96-tick batches, K = 2 so the burst channel drops)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sc, adcs = protowib_superchunks(2, 16, seed=5)
    burst = int(protowib.COLLECTION_INDEX_TO_CHAN[40])
    for j in range(4):
        adcs[1, 4 + 20 * j:7 + 20 * j, burst] += 3000
    adcs = np.clip(adcs, 0, (1 << protowib.ADC_BITS) - 1)
    protowib.set_adcs(protowib.superchunk_frames(sc[1]),
                      adcs[1].reshape(16, 12, 256))
    fetched = [[None, None] for _ in range(2)]    # [batch][link]
    procs = []
    j_drops = 0
    for link in range(2):
        hits, _, _, _, counts = _run(JWIB, JHandler, JQueueSender,
                                     [sc[link, :8], sc[link, 8:]],
                                     tpg_backend="pallas")
        j_drops += counts["num_hits_dropped"]
        for b in range(2):
            fetched[b][link] = hits[2 * b:2 * b + 2]
        p = JWIB()
        p.conf({"enable_tpg": True, "tpg_k_slots": 2,
                "tpg_induction_threshold": 4, "tpg_pallas_interpret": True})
        p.start()
        p.process(sc[link, :1].copy())
        procs.append(p)
    oracle = list(smoke.plain_protowib_hits(
        [adcs[:, :96], adcs[:, 96:]], PortCfgs(procs[0]), "cpu"))
    n = drops = 0
    for b, want in enumerate(oracle):
        for link in range(2):
            for (plane, _), got in zip(smoke.PW_PLANES, fetched[b][link]):
                h, d = want[plane][link]
                np.testing.assert_array_equal(got, h)
                n += len(h)
                drops += d
    assert n > 0 and drops == j_drops > 0


class PortCfgs:
    """A JAX processor's plane configs and K as the port's, the attributes
    ``chip_smoke.plain_protowib_hits`` reads."""

    def __init__(self, jproc):
        self.coll_cfg = port_cfg(jproc.coll_cfg)
        self.ind_cfg = port_cfg(jproc.ind_cfg)
        self.k_slots = jproc.k_slots
