"""The port's Fragment/wire layer, fragment recorder and type adapters
against the JAX package's, on the CPU: the case list of
``tests/test_wire.py``, each holding the port's bytes equal to the JAX
package's byte for byte and each package reading the other's bytes back;
``request_fragment`` of both request handlers and ``record_fragment`` of
the APA app write the same bytes as the JAX package; every ``ADAPTERS``
entry has the JAX entry's sizes, tick differences and timestamp accessors.
Inputs are made by numpy from a seed; tolerance 0 (bytes and integers)."""

import json

import numpy as np
import pytest

from fdreadoutlibs_tpu.formats import adapters as jadapters
from fdreadoutlibs_tpu.formats import fragment as jfragment
from fdreadoutlibs_tpu.formats import wibeth as jwibeth
from fdreadoutlibs_tpu.formats import wire as jwire
from fdreadoutlibs_tpu.formats.trigprim import TPSet as JTPSet
from fdreadoutlibs_tpu.tp.readout_buffer import \
    ReadoutRequestHandler as JReadout
from fdreadoutlibs_tpu.tp.recorder import FragmentRecorder as JRecorder
from fdreadoutlibs_tpu.tp.request_handler import TPRequestHandler as JTPReq
from fdreadoutlibs_tpu_torch.formats import adapters, fragment, wibeth, wire
from fdreadoutlibs_tpu_torch.formats.trigprim import TPSet, TPSetType, \
    make_tps
from fdreadoutlibs_tpu_torch.tp.latency_buffer import make_latency_buffer
from fdreadoutlibs_tpu_torch.tp.readout_buffer import ReadoutRequestHandler
from fdreadoutlibs_tpu_torch.tp.recorder import FragmentRecorder
from fdreadoutlibs_tpu_torch.tp.request_handler import TPRequestHandler
from test_wire import FRAGMENT_FIELD_OFFSETS, TP_FIELD_OFFSETS


def random_tps(rng, n):
    tps = make_tps(n)
    tps["time_start"] = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    tps["time_peak"] = tps["time_start"] + rng.integers(0, 4096, n,
                                                        dtype=np.uint64)
    tps["time_over_threshold"] = rng.integers(0, 1 << 20, n, dtype=np.uint64)
    tps["channel"] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    for k in ("adc_integral", "adc_peak"):
        tps[k] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    for k in ("detid", "type", "algorithm", "flag"):
        tps[k] = rng.integers(0, 1 << 16, n)
    return tps


def both_fragments(payloads, **kw):
    return (fragment.build_fragment(payloads, **kw),
            jfragment.build_fragment(payloads, **kw))


def assert_same_header(a, b):
    assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
        {k: getattr(b, k) for k in b.__dataclass_fields__}


# ---- FragmentHeader POD ---------------------------------------------------

def test_fragment_header_is_72_bytes():
    assert wire.FRAGMENT_HEADER_DTYPE.itemsize == 72
    assert wire.FRAGMENT_HEADER_DTYPE == jwire.FRAGMENT_HEADER_DTYPE


def test_fragment_header_field_offsets():
    fields = wire.FRAGMENT_HEADER_DTYPE.fields
    assert set(fields) == set(FRAGMENT_FIELD_OFFSETS)
    for name, (off, size) in FRAGMENT_FIELD_OFFSETS.items():
        dt, field_off = fields[name][:2]
        assert (field_off, dt.itemsize) == (off, size), name
        assert dt.byteorder in ("<", "|", "="), name


def test_header_bytes_field_for_field():
    kw = dict(run_number=33, trigger_number=12345,
              trigger_timestamp=0xDEADBEEFCAFE, window_begin=0xDEADBEEF0000,
              window_end=0xDEADBEEFFFFF, source_id=17,
              fragment_type="kWIBEth", sequence_number=9, detector_id=3,
              error_bits=0b101, subsystem="kDetectorReadout",
              payload_bytes=7200)
    assert wire.pack_header(**kw) == jwire.pack_header(**kw)
    for name in ("kDAPHNEStream", "kTDE_AMC", "kPDSData", "kTriggerPrimitive"):
        kw["fragment_type"] = name
        assert wire.pack_header(**kw) == jwire.pack_header(**kw)


@pytest.mark.parametrize("ftype,stride", [("kWIBEth", 16),
                                          ("kDAPHNEStream", 5664),
                                          ("kTDE_AMC", 11954)])
def test_fragment_roundtrip_raw_payload(ftype, stride):
    rng = np.random.default_rng(stride)
    payloads = rng.integers(0, 256, (3, stride), dtype=np.uint8)
    port, ref = both_fragments(
        payloads, run_number=7, trigger_number=42, window_begin=1000,
        window_end=2000, source_id=5, fragment_type=ftype,
        sequence_number=2)
    buf = port.to_bytes()
    assert buf == ref.to_bytes() and len(buf) == 72 + payloads.nbytes
    for frm, to in ((fragment.Fragment, jfragment.Fragment),
                    (jfragment.Fragment, fragment.Fragment)):
        a = frm.from_bytes(buf, payload_stride=stride)
        b = to.from_bytes(a.to_bytes(), payload_stride=stride)
        assert_same_header(a.header, port.header)
        assert_same_header(b.header, port.header)
        np.testing.assert_array_equal(b.payloads, payloads)


def test_fragment_size_field_and_marker_checks():
    port, ref = both_fragments(np.zeros((2, 8), np.uint8), run_number=1,
                               trigger_number=1, window_begin=0,
                               window_end=1, source_id=0,
                               fragment_type="kWIB")
    buf = bytearray(port.to_bytes())
    assert bytes(buf) == ref.to_bytes()
    assert int.from_bytes(buf[8:16], "little") == len(buf)
    with pytest.raises(ValueError, match="size"):
        fragment.Fragment.from_bytes(bytes(buf) + b"x")
    buf[0] ^= 0xFF
    with pytest.raises(ValueError, match="marker"):
        fragment.Fragment.from_bytes(bytes(buf))
    with pytest.raises(ValueError, match="short"):
        fragment.Fragment.from_bytes(bytes(buf[:40]))


# ---- TriggerPrimitive POD -------------------------------------------------

def test_tp_wire_is_48_bytes_with_pinned_offsets():
    assert wire.TP_WIRE_DTYPE.itemsize == 48
    assert wire.TP_WIRE_DTYPE == jwire.TP_WIRE_DTYPE
    for name, (off, size) in TP_FIELD_OFFSETS.items():
        dt, field_off = wire.TP_WIRE_DTYPE.fields[name][:2]
        assert (field_off, dt.itemsize) == (off, size), name


def test_tp_wire_roundtrip():
    tps = random_tps(np.random.default_rng(5), 37)
    buf = wire.tps_to_wire(tps)
    assert buf == jwire.tps_to_wire(tps) and len(buf) == 37 * 48
    np.testing.assert_array_equal(wire.wire_to_tps(buf), tps)
    np.testing.assert_array_equal(jwire.wire_to_tps(buf), tps)
    raw = np.frombuffer(buf, np.uint8).reshape(37, 48)
    assert not raw[:, 46:].any()
    with pytest.raises(ValueError):
        wire.wire_to_tps(buf[:-1])


def test_tp_fragment_roundtrip_via_pod():
    tps = random_tps(np.random.default_rng(6), 4)
    port, ref = both_fragments(tps, run_number=3, trigger_number=8,
                               window_begin=50, window_end=500, source_id=2,
                               fragment_type="kTriggerPrimitive",
                               subsystem="kTrigger")
    buf = port.to_bytes()
    assert buf == ref.to_bytes() and len(buf) == 72 + 4 * 48
    back = fragment.Fragment.from_bytes(buf)
    assert back.header.subsystem == "kTrigger"
    np.testing.assert_array_equal(back.payloads, tps)
    np.testing.assert_array_equal(
        jfragment.Fragment.from_bytes(back.to_bytes()).payloads, tps)


# ---- TPSet framing --------------------------------------------------------

@pytest.mark.parametrize("n,kind", [(3, "kPayload"), (0, "kHeartbeat")])
def test_tpset_roundtrip(n, kind):
    tps = random_tps(np.random.default_rng(n), n)
    port = TPSet(run_number=4, type=TPSetType[kind], origin=11,
                 start_time=10, end_time=30, seqno=99, objects=tps)
    ref = JTPSet(run_number=4, type=int(TPSetType[kind]), origin=11,
                 start_time=10, end_time=30, seqno=99, objects=tps)
    buf = wire.tpset_to_bytes(port)
    assert buf == jwire.tpset_to_bytes(ref)
    for back in (wire.tpset_from_bytes(buf), jwire.tpset_from_bytes(buf)):
        assert (back.run_number, int(back.type), back.origin, back.seqno,
                back.start_time, back.end_time) == \
            (4, int(TPSetType[kind]), 11, 99, 10, 30)
        np.testing.assert_array_equal(back.objects, tps)


def test_tpset_truncation_raises():
    tps = random_tps(np.random.default_rng(9), 3)
    buf = wire.tpset_to_bytes(TPSet(run_number=4, type=TPSetType.kPayload,
                                    origin=1, start_time=10, end_time=30,
                                    seqno=0, objects=tps))
    for cut, match in ((buf[:-48], "truncated"), (buf[:-1], "truncated"),
                       (buf[:10], "short")):
        with pytest.raises(ValueError, match=match):
            wire.tpset_from_bytes(cut)
    bad = bytearray(buf)
    bad[0] ^= 0xFF
    with pytest.raises(ValueError, match="marker"):
        wire.tpset_from_bytes(bytes(bad))


def test_unknown_fragment_type_code_roundtrips():
    port, _ = both_fragments(np.zeros((1, 8), np.uint8), run_number=1,
                             trigger_number=1, window_begin=0, window_end=1,
                             source_id=0, fragment_type="kWIB")
    buf = bytearray(port.to_bytes())
    buf[56:60] = (20).to_bytes(4, "little")       # unassigned code
    back = fragment.Fragment.from_bytes(bytes(buf))
    assert back.header.fragment_type == 20
    assert back.to_bytes() == bytes(buf) == \
        jfragment.Fragment.from_bytes(bytes(buf)).to_bytes()


# ---- recorder store + request path emit the binary form -------------------

def test_recorder_stores_wire_bytes(tmp_path):
    rng = np.random.default_rng(12)
    payloads = rng.integers(0, 256, (2, 7200), dtype=np.uint8)
    ring = np.zeros(3, dtype=[("time_start", "<u8"),
                              ("payload", "u1", (16,))])
    ring["time_start"] = [5, 6, 7]
    ring["payload"] = rng.integers(0, 256, (3, 16))
    tps = random_tps(rng, 5)
    frags = [dict(payloads=payloads, fragment_type="kWIBEth", source_id=3),
             dict(payloads=ring, fragment_type="kDAPHNEStream",
                  source_id=1000),
             dict(payloads=tps, fragment_type="kTriggerPrimitive",
                  source_id=2000, subsystem="kTrigger")]
    rec, jrec = (FragmentRecorder(tmp_path / "port", run_number=12),
                 JRecorder(tmp_path / "jax", run_number=12))
    for i, kw in enumerate(frags):
        port, ref = both_fragments(run_number=12, trigger_number=i,
                                   window_begin=0, window_end=4096, **kw)
        path, jpath = rec.write(port), jrec.write(ref)
        assert path.name == jpath.name and path.suffix == ".frag"
        assert path.read_bytes() == jpath.read_bytes()
    assert (tmp_path / "port" / "index.jsonl").read_text() == \
        (tmp_path / "jax" / "index.jsonl").read_text()
    # each package reads the other's store
    for reader in (FragmentRecorder(tmp_path / "jax"),
                   JRecorder(tmp_path / "port")):
        assert len(reader) == 3
        for i, kw in enumerate(frags):
            back = reader.read(i)
            assert back.header.source_id == kw["source_id"]
            np.testing.assert_array_equal(back.payloads, kw["payloads"])


def test_recorder_reads_legacy_npz(tmp_path):
    payloads = np.ones((1, 8), np.uint8)
    np.savez_compressed(tmp_path / "old.npz", payloads=payloads)
    meta = {"run_number": 1, "trigger_number": 2, "trigger_timestamp": 3,
            "window_begin": 3, "window_end": 4, "source_id": 5,
            "fragment_type": "kWIB", "sequence_number": 0,
            "detector_id": 0, "error_bits": 0, "version": 5,
            "file": "old.npz", "n_payloads": 1, "size_bytes": 8}
    (tmp_path / "index.jsonl").write_text(json.dumps(meta) + "\n")
    back, jback = FragmentRecorder(tmp_path).read(0), \
        JRecorder(tmp_path).read(0)
    assert back.header.fragment_type == "kWIB"
    assert_same_header(back.header, jback.header)
    np.testing.assert_array_equal(back.payloads, payloads)


@pytest.mark.parametrize("retention", ["ring", "zerocopy"])
def test_request_fragment_emits_wire(retention):
    rng = np.random.default_rng(14)
    handlers = [cls(mod.get_adapter("wibeth"), capacity=64,
                    retention=retention)
                for cls, mod in ((ReadoutRequestHandler, adapters),
                                 (JReadout, jadapters))]
    frames = wibeth.empty_frames(4)
    wibeth.set_adcs(frames, rng.integers(0, 1 << 14, (4, 64, 64),
                                         dtype=np.uint16))
    wibeth.fake_timestamps(frames, 1 << 20)
    for h in handlers:
        h.insert_payloads(frames.copy())
    port, ref = (h.request_fragment((1 << 20), (1 << 20) + 3 * 2048 + 1,
                                    run_number=9, trigger_number=77,
                                    source_id=6) for h in handlers)
    assert len(port) >= 3
    buf = port.to_bytes()
    assert buf == ref.to_bytes()
    h = np.frombuffer(buf[:72], dtype=wire.FRAGMENT_HEADER_DTYPE)[0]
    assert int(h["fragment_type"]) == wire.fragment_type_code("kWIBEth")
    assert int(h["elem_subsystem"]) == wire.Subsystem.kDetectorReadout
    assert int(h["elem_id"]) == 6
    back = fragment.Fragment.from_bytes(buf, payload_stride=jwibeth.FRAME_SIZE)
    np.testing.assert_array_equal(back.payloads, frames)


def test_tp_request_fragment_emits_wire():
    """TPRequestHandler.request_fragment: the buffered TPs of a window as a
    kTriggerPrimitive fragment, the same bytes as the JAX handler's."""
    tps = random_tps(np.random.default_rng(15), 64)
    tps["time_start"] = np.sort(tps["time_start"] % 100_000)
    handlers = [TPRequestHandler(latency_buffer=make_latency_buffer(
        tps.dtype)), JTPReq()]
    for h in handlers:
        h.conf({})
        h.start(run_number=3)
        h.insert_tps(tps.copy())
    port, ref = (h.request_fragment(20_000, 70_000, run_number=3,
                                    trigger_number=5, source_id=4,
                                    sequence_number=1) for h in handlers)
    assert 0 < len(port) < len(tps)
    assert port.to_bytes() == ref.to_bytes()


def test_apa_record_fragment_writes_jax_bytes(tmp_path):
    """APAReadoutApp.record_fragment (the plain version on the CPU): the
    recorded file is the JAX request path's fragment of the same frames."""
    from fdreadoutlibs_tpu_torch.apps.apa_readout import (APAReadoutApp,
                                                          make_batch)
    rng = np.random.default_rng(16)
    app = APAReadoutApp(n_links=2, device="cpu", run_number=4)
    frames, _ = make_batch(rng, 2, 2, 0, 0x1000000)
    app.process_batch(frames)
    rec = FragmentRecorder(tmp_path, run_number=4)
    frag = app.record_fragment(1, 0x1000000, 0x1000000 + 2048, rec,
                               trigger_number=3, sequence_number=2)
    ref = JReadout(jadapters.get_adapter("wibeth"), capacity=64)
    ref.insert_payloads(frames[1].copy())
    want = ref.request_fragment(0x1000000, 0x1000000 + 2048, run_number=4,
                                trigger_number=3, source_id=1,
                                sequence_number=2)
    assert len(frag) == 1
    assert (tmp_path / rec.index()[0]["file"]).read_bytes() == \
        want.to_bytes()


def test_fragment_type_code_override(tmp_path, monkeypatch):
    override = tmp_path / "codes.json"
    override.write_text(json.dumps({"kWIBEth": 99, "kDAPHNEStream": 40}))
    monkeypatch.setenv("FDREADOUT_FRAGMENT_TYPE_CODES", str(override))
    for mod in (wire, jwire):
        assert mod.fragment_type_code("kWIBEth") == 99
        assert mod.fragment_type_name(40) == "kDAPHNEStream"
    assert wire.pack_header(fragment_type="kDAPHNEStream") == \
        jwire.pack_header(fragment_type="kDAPHNEStream")
    monkeypatch.delenv("FDREADOUT_FRAGMENT_TYPE_CODES")
    assert wire.fragment_type_code("kWIBEth") == 12


# ---- type adapters --------------------------------------------------------

TRAITS = ("fixed_payload_size", "fragment_type", "subsystem",
          "expected_tick_difference", "payload_tick_difference",
          "num_frames")


def test_adapter_registry_is_complete():
    assert sorted(adapters.ADAPTERS) == sorted(jadapters.ADAPTERS)


@pytest.mark.parametrize("name", sorted(jadapters.ADAPTERS))
def test_adapter_matches_jax(name):
    a, b = adapters.get_adapter(name), jadapters.get_adapter(name)
    assert {k: getattr(a, k) for k in TRAITS} == \
        {k: getattr(b, k) for k in TRAITS}
    if name == "trigger_primitive":
        tps = random_tps(np.random.default_rng(1), 3)
        np.testing.assert_array_equal(a.get_first_timestamp(tps),
                                      b.get_first_timestamp(tps))
        return
    rng = np.random.default_rng(len(name))
    payloads = rng.integers(0, 256, (3, a.fixed_payload_size),
                            dtype=np.uint8)
    got, want = payloads.copy(), payloads.copy()
    ts = np.array([1 << 40, (1 << 40) + 5, 3 << 41], dtype=np.uint64)
    a.set_first_timestamp(got, ts)
    b.set_first_timestamp(want, ts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(a.get_first_timestamp(got), ts)
    if b.fake_timestamps is not None:
        a.fake_timestamps(got, 123456)
        b.fake_timestamps(want, 123456)
        np.testing.assert_array_equal(got, want)
    assert a.empty(2).shape == b.empty(2).shape
