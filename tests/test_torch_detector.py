"""The port's full-detector app (``DetectorReadoutApp``, device="cpu": the
kernels' plain versions) against the JAX package's (its ingest entries in
Pallas interpret mode, as ``tests/conftest.py::interpret_ingest`` routes
them): a mirror of ``tests/test_detector_readout.py`` — 2 APA links, 1 PDS
link and 1 TDE link, three batches with pulses, sync and pipelined.  Per
arm the ``get_info`` counts are equal, the merged TPSet stream is equal
field for field, the source routing raises alike, and one fragment
recorded per arm is the same bytes.  Tolerance 0 (integers and bytes)."""

import contextlib

import numpy as np
import pytest
import torch

import fdreadoutlibs_tpu.ops.ingest as jingest
from fdreadoutlibs_tpu.apps.detector_readout import \
    DetectorReadoutApp as JaxDetector
from fdreadoutlibs_tpu.formats import tde as jtde
from fdreadoutlibs_tpu.tp.recorder import FragmentRecorder as JRecorder
from fdreadoutlibs_tpu_torch.apps.detector_readout import (
    PDS_SOURCE_BASE, TDE_SOURCE_BASE, TPC_SOURCE_BASE, DetectorReadoutApp)
from fdreadoutlibs_tpu_torch.formats import tde
from fdreadoutlibs_tpu_torch.tp.recorder import FragmentRecorder
from test_detector_readout import _pds_batch, _tde_batch, _tpc_batch

torch.set_num_threads(1)

TIMING_KEYS = ("rate_tp_hits_khz", "interval_seconds")
KW = dict(apa_links=2, pds_links=1, tde_links=1, tpc_threshold=499,
          pds_threshold=120, tde_threshold=600)
SOURCES = ((TPC_SOURCE_BASE + 1, 0x100000), (PDS_SOURCE_BASE, 0x200000),
           (TDE_SOURCE_BASE, 0x300000))


@contextlib.contextmanager
def jax_interpret():
    """The JAX package's ingest entries in Pallas interpret mode (the
    routing of ``tests/conftest.py::interpret_ingest``, for a
    module-scoped run)."""
    names = ("process_packed_frames", "process_packed_frames_fused",
             "process_words14_feed", "process_time2_feed",
             "process_packed_daphne")
    saved = {n: getattr(jingest, n) for n in names}
    for n, orig in saved.items():
        def patched(words, stack, cfg, C, _orig=orig, **kw):
            kw["interpret"] = True
            return _orig(words, stack, cfg, C, **kw)
        setattr(jingest, n, patched)
    try:
        yield
    finally:
        for n, orig in saved.items():
            setattr(jingest, n, orig)


def drive(app, tmp_path, recorder_cls):
    """The JAX test's three batches, then the merged TPSets, per-arm info,
    raw requests and one recorded fragment per arm."""
    ts_tpc, ts_pds, ts_tde = 0x100000, 0x200000, 0x300000
    sets = []
    for b in range(3):
        app.process_tpc_batch(
            _tpc_batch(b, pulse_link=1 if b == 1 else None, ts=ts_tpc))
        scs, T = _pds_batch(pulse=(b == 1), ts=ts_pds)
        app.process_pds_batch(scs)
        app.process_tde_batch(_tde_batch(pulse=(b == 1), ts=ts_tde))
        ts_tpc += 2048
        ts_pds += T
        ts_tde += tde.EXPECTED_TICK_DIFFERENCE
        sets += app.drain_tpsets()
    app.flush()
    sets += app.drain_tpsets()
    info = app.get_info()
    for arm in info.values():
        arm["handler"] = {k: v for k, v in arm["handler"].items()
                          if k not in TIMING_KEYS}
        # the port's own counter on its TPC arm (the JAX app has none)
        arm.pop("words_copy_bytes", None)
    raw = [app.request_raw(sid, t0, t0 + 3 * tde.EXPECTED_TICK_DIFFERENCE)
           for sid, t0 in SOURCES]
    rec = recorder_cls(tmp_path, run_number=1)
    for i, (sid, t0) in enumerate(SOURCES):
        app.record_fragment(sid, t0, t0 + (1 << 24), rec, trigger_number=i)
    frags = [(tmp_path / m["file"]).read_bytes() for m in rec.index()]
    return sets, info, raw, frags


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX app's run per (tde backend, pipelined), made once."""
    cache = {}

    def get(backend, pipelined):
        if (backend, pipelined) not in cache:
            with jax_interpret():
                app = JaxDetector(tde_backend=backend, pipelined=pipelined,
                                  **KW)
                cache[backend, pipelined] = drive(
                    app, tmp_path_factory.mktemp("jax"), JRecorder)
        return cache[backend, pipelined]
    return get


def assert_same_tpsets(sa, sb):
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert (x.run_number, int(x.type), x.origin, x.start_time,
                x.end_time, x.seqno) == (y.run_number, int(y.type), y.origin,
                                         y.start_time, y.end_time, y.seqno)
        np.testing.assert_array_equal(x.objects, y.objects)


@pytest.mark.parametrize("backend,pipelined", [("reference", False),
                                               ("reference", True),
                                               ("pallas", True)],
                         ids=["sync", "pipelined", "pipelined-tde-pallas"])
def test_three_arms_match_jax(backend, pipelined, jax_runs, tmp_path):
    app = DetectorReadoutApp(tde_backend=backend, pipelined=pipelined,
                             device="cpu", **KW)
    sets, info, raw, frags = drive(app, tmp_path, FragmentRecorder)
    jsets, jinfo, jraw, jfrags = jax_runs(backend, pipelined)
    assert info == jinfo
    assert_same_tpsets(sets, jsets)
    for r, jr in zip(raw, jraw):
        np.testing.assert_array_equal(r, jr)
    assert frags == jfrags
    # the JAX test's own expectations hold for the port
    assert info["tpc"]["total_hits"] == 1 and info["tde"]["total_hits"] == 1
    assert info["pds"]["total_hits"] >= 1
    assert info["tpc"]["ts_errors"] == info["tde"]["ts_errors"] == 0
    assert sets == sorted(sets, key=lambda s: (s.start_time, s.origin,
                                               s.seqno))
    assert {s.origin for s in sets} <= {TPC_SOURCE_BASE, PDS_SOURCE_BASE,
                                        TDE_SOURCE_BASE}
    assert all(len(r) >= 1 for r in raw) and len(frags) == 3


def test_sync_and_pipelined_streams_are_equal(tmp_path):
    a = drive(DetectorReadoutApp(tde_backend="reference", device="cpu",
                                 **KW), tmp_path / "a", FragmentRecorder)
    b = drive(DetectorReadoutApp(tde_backend="reference", pipelined=True,
                                 device="cpu", **KW), tmp_path / "b",
              FragmentRecorder)
    assert_same_tpsets(a[0], b[0])
    assert a[3] == b[3]


def test_source_routing_errors_match_jax():
    port = DetectorReadoutApp(device="cpu", **KW)
    with jax_interpret():
        ref = JaxDetector(**KW)
    for sid in (500, 1005, 2001, -1):
        for app in (port, ref):
            with pytest.raises(KeyError):
                app.resolve_source(sid)
    for sid in (0, 1, 1000, 2000):
        got, want = port.resolve_source(sid), ref.resolve_source(sid)
        assert (got[0], got[2]) == (want[0], want[2])


def test_recorded_fragments_read_back(tmp_path):
    """One fragment per arm, read back by both recorders: the requested
    source id, the arm's fragment type and the raw payloads served."""
    app = DetectorReadoutApp(tde_backend="reference", device="cpu", **KW)
    drive(app, tmp_path, FragmentRecorder)
    want_types = ("kWIBEth", "kDAPHNEStream", "kTDE_AMC")
    for rec in (FragmentRecorder(tmp_path), JRecorder(tmp_path)):
        assert len(rec) == 3
        for i, ((sid, t0), ftype) in enumerate(zip(SOURCES, want_types)):
            frag = rec.read(i)
            assert frag.header.source_id == sid
            assert frag.header.fragment_type == ftype
            np.testing.assert_array_equal(
                frag.payloads, app.request_raw(sid, t0, t0 + (1 << 24)))
    assert jtde.FRAME_SIZE == tde.FRAME_SIZE


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        DetectorReadoutApp(**KW)
