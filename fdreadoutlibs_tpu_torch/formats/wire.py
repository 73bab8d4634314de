"""Binary daqdataformats wire layouts: FragmentHeader POD + TriggerPrimitive
POD + TPSet framing.

Port copy of ``fdreadoutlibs_tpu/formats/wire.py:1-316``: the same code apart from
imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

The reference's request path ultimately produces the daqdataformats binary
``FragmentHeader`` (a 72-byte POD prepended to the payload bytes) and
``trgdataformats::TriggerPrimitive`` PODs memcpy'd into TP fragments
(the reference's src/TPCTPRequestHandler.cpp:145-165,
include/fdreadoutlibs/TriggerPrimitiveTypeAdapter.hpp:24-29).  This module
pins those layouts as numpy structured dtypes with EXPLICIT offsets so a
DUNE tool reading raw fragment bytes and this framework agree field for
field; tests/test_wire.py pins every offset.

Layout provenance (no-egress caveat, same treatment as the channel-map
dump — PARITY.md): the field order, widths, 72-byte size, marker
0x11112222 and header version 5 follow the dunedaq ``daqdataformats``
v4-series ``FragmentHeader.hpp``/``SourceID.hpp`` PODs; the FragmentType
ENUM CODES are a best-effort reconstruction of the same release and are
kept in ONE table below — if a checkable daqdataformats release disagrees,
swap the table (or point FDREADOUT_FRAGMENT_TYPE_CODES at a JSON
{name: code} override) and every writer/reader follows.

TPSet note: upstream ``trigger::TPSet`` is NOT a POD — it crosses IOManager
via the dunedaq serialization layer (msgpack).  The interoperable binary
unit is the TriggerPrimitive POD array; ``tpset_to_bytes`` wraps that array
in a small documented framing header (marker "TPST", little-endian) so
TPSet streams can be persisted/replayed losslessly by this framework, and
the POD payload can be lifted out for any DUNE consumer.
"""

from __future__ import annotations

import json
import os
from enum import IntEnum

import numpy as np

from .trigprim import TP_DTYPE, TPSet, TPSetType, make_tps

__all__ = [
    "FRAGMENT_HEADER_DTYPE", "FRAGMENT_HEADER_MARKER",
    "FRAGMENT_HEADER_VERSION", "SOURCE_ID_VERSION", "Subsystem",
    "fragment_type_code", "fragment_type_name", "TP_WIRE_DTYPE",
    "tps_to_wire", "wire_to_tps", "pack_fragment", "unpack_fragment",
    "tpset_to_bytes", "tpset_from_bytes",
]

FRAGMENT_HEADER_MARKER = 0x11112222
FRAGMENT_HEADER_VERSION = 5
SOURCE_ID_VERSION = 2
INVALID_FRAGMENT_TYPE = 0xFFFFFFFF

# daqdataformats::FragmentHeader — 72 bytes, little-endian, naturally
# aligned (no hidden padding: 4+4 | 8*5 | 4+4+4 | 2+2 | 2+2+4).
FRAGMENT_HEADER_DTYPE = np.dtype([
    ("fragment_header_marker", "<u4"),   # offset 0
    ("version", "<u4"),                  # offset 4
    ("size", "<u8"),                     # offset 8: header + payload bytes
    ("trigger_number", "<u8"),           # offset 16
    ("trigger_timestamp", "<u8"),        # offset 24
    ("window_begin", "<u8"),             # offset 32
    ("window_end", "<u8"),               # offset 40
    ("run_number", "<u4"),               # offset 48
    ("error_bits", "<u4"),               # offset 52
    ("fragment_type", "<u4"),            # offset 56
    ("sequence_number", "<u2"),          # offset 60
    ("detector_id", "<u2"),              # offset 62
    # daqdataformats::SourceID (version 2): 8-byte trailing POD
    ("elem_version", "<u2"),             # offset 64
    ("elem_subsystem", "<u2"),           # offset 66
    ("elem_id", "<u4"),                  # offset 68
])
assert FRAGMENT_HEADER_DTYPE.itemsize == 72


class Subsystem(IntEnum):
    """daqdataformats::SourceID::Subsystem."""
    kUnknown = 0
    kDetectorReadout = 1
    kHwSignalsInterface = 2
    kTrigger = 3
    kTRBuilder = 4


# FragmentType codes (single source of truth; see module docstring for the
# provenance caveat and the JSON override hook).  Names match the
# adapter-table strings (formats/adapters.py) plus the trigger types the
# reference request path can emit.
_DEFAULT_FRAGMENT_TYPE_CODES = {
    "kUnknown": 0,
    "kProtoWIB": 1,
    "kWIB": 2,
    "kDAPHNE": 3,
    "kTDE_AMC": 4,
    "kFW_TriggerPrimitive": 5,
    "kTriggerPrimitive": 6,
    "kTriggerActivity": 7,
    "kTriggerCandidate": 8,
    "kHardwareSignal": 9,
    "kPACMAN": 10,
    "kMPD": 11,
    "kWIBEth": 12,
    "kDAPHNEStream": 13,
    # pre-DAPHNE SSP photon-detector data (legacy daqdataformats code,
    # retained for the SSP adapter)
    "kPDSData": 14,
}


def _load_codes() -> dict:
    path = os.environ.get("FDREADOUT_FRAGMENT_TYPE_CODES")
    if path:
        with open(path) as f:
            override = json.load(f)
        codes = dict(_DEFAULT_FRAGMENT_TYPE_CODES)
        codes.update({str(k): int(v) for k, v in override.items()})
        return codes
    return _DEFAULT_FRAGMENT_TYPE_CODES


def fragment_type_code(name: str) -> int:
    """'kWIBEth' -> wire code.  Unknown names map to the invalid sentinel
    (the POD must still be writable for forward-compat types)."""
    return _load_codes().get(name, INVALID_FRAGMENT_TYPE)


def fragment_type_name(code: int) -> str:
    for k, v in _load_codes().items():
        if v == int(code):
            return k
    return "kUnknown" if code != INVALID_FRAGMENT_TYPE else "kInvalid"


# trgdataformats::TriggerPrimitive POD: the in-memory TP_DTYPE fields at
# their C++ offsets.  sizeof = 48 (46 bytes of fields + 2 tail padding from
# the uint64 struct alignment); a TP fragment payload is N of these at a
# 48-byte stride (TPCTPRequestHandler memcpy's whole structs).
TP_WIRE_DTYPE = np.dtype({
    "names": [n for n in TP_DTYPE.names],
    "formats": ["<u8", "<u8", "<u8", "<i4", "<u4", "<u4",
                "<u2", "<u2", "<u2", "<u2", "<u2"],
    "offsets": [0, 8, 16, 24, 28, 32, 36, 38, 40, 42, 44],
    "itemsize": 48,
})


def tps_to_wire(tps: np.ndarray) -> bytes:
    """(N,) TP_DTYPE -> N x 48-byte TriggerPrimitive PODs."""
    wire = np.zeros(len(tps), dtype=TP_WIRE_DTYPE)
    for n in TP_DTYPE.names:
        wire[n] = tps[n]
    return wire.tobytes()


def wire_to_tps(buf: bytes) -> np.ndarray:
    if len(buf) % TP_WIRE_DTYPE.itemsize:
        raise ValueError(f"TP payload length {len(buf)} not a multiple of "
                         f"{TP_WIRE_DTYPE.itemsize}")
    wire = np.frombuffer(buf, dtype=TP_WIRE_DTYPE)
    tps = make_tps(len(wire))
    for n in TP_DTYPE.names:
        tps[n] = wire[n]
    return tps


def pack_header(*, run_number=0, trigger_number=0, trigger_timestamp=0,
                window_begin=0, window_end=0, source_id=0,
                fragment_type="kUnknown", sequence_number=0, detector_id=0,
                error_bits=0, subsystem="kDetectorReadout",
                payload_bytes=0) -> bytes:
    hdr = np.zeros(1, dtype=FRAGMENT_HEADER_DTYPE)
    h = hdr[0]
    h["fragment_header_marker"] = FRAGMENT_HEADER_MARKER
    h["version"] = FRAGMENT_HEADER_VERSION
    h["size"] = FRAGMENT_HEADER_DTYPE.itemsize + int(payload_bytes)
    h["trigger_number"] = trigger_number
    h["trigger_timestamp"] = np.uint64(trigger_timestamp)
    h["window_begin"] = np.uint64(window_begin)
    h["window_end"] = np.uint64(window_end)
    h["run_number"] = run_number
    h["error_bits"] = error_bits
    h["fragment_type"] = (fragment_type if isinstance(fragment_type, int)
                          else fragment_type_code(fragment_type))
    h["sequence_number"] = sequence_number
    h["detector_id"] = detector_id
    h["elem_version"] = SOURCE_ID_VERSION
    h["elem_subsystem"] = (subsystem if isinstance(subsystem, int)
                           else Subsystem[subsystem].value)
    h["elem_id"] = source_id
    return hdr.tobytes()


def pack_fragment(fragment) -> bytes:
    """formats.fragment.Fragment -> header POD + raw payload bytes.

    TP fragments carrying in-memory TP_DTYPE records are converted to the
    48-byte TriggerPrimitive POD stride on the way out (the reference
    memcpy's whole structs — TPCTPRequestHandler.cpp:150-153)."""
    h = fragment.header
    payload = np.ascontiguousarray(fragment.payloads)
    if payload.dtype == TP_DTYPE:
        payload = np.frombuffer(tps_to_wire(payload), dtype=np.uint8)
    return pack_header(
        run_number=h.run_number, trigger_number=h.trigger_number,
        trigger_timestamp=h.trigger_timestamp,
        window_begin=h.window_begin, window_end=h.window_end,
        source_id=h.source_id, fragment_type=h.fragment_type,
        sequence_number=h.sequence_number, detector_id=h.detector_id,
        error_bits=h.error_bits, subsystem=getattr(
            h, "subsystem", "kDetectorReadout"),
        payload_bytes=payload.nbytes) + payload.tobytes()


def unpack_fragment(buf: bytes, payload_stride: int | None = None):
    """Header POD + payload bytes -> formats.fragment.Fragment.

    ``payload_stride`` reshapes the payload into (N, stride) rows (e.g. a
    frame size); omitted, the shape is inferred for TP fragments (48-byte
    TriggerPrimitive stride) and left flat (1, nbytes) otherwise.
    """
    from .fragment import Fragment, FragmentHeader
    hdr_size = FRAGMENT_HEADER_DTYPE.itemsize
    if len(buf) < hdr_size:
        raise ValueError(f"short fragment: {len(buf)} B < {hdr_size}")
    h = np.frombuffer(buf[:hdr_size], dtype=FRAGMENT_HEADER_DTYPE)[0]
    if int(h["fragment_header_marker"]) != FRAGMENT_HEADER_MARKER:
        raise ValueError(
            f"bad fragment marker 0x{int(h['fragment_header_marker']):08x}")
    if int(h["size"]) != len(buf):
        raise ValueError(f"fragment size field {int(h['size'])} != "
                         f"{len(buf)} bytes supplied")
    payload = np.frombuffer(buf[hdr_size:], dtype=np.uint8)
    code = int(h["fragment_type"])
    tname = fragment_type_name(code)
    # forward compat: a code with no name in this build's table must
    # survive an unpack->repack round-trip byte-faithfully — keep the
    # numeric code (pack_fragment accepts ints) instead of collapsing
    # it to kUnknown (code 0)
    ftype = tname if fragment_type_code(tname) == code else code
    if payload_stride is None and tname == "kTriggerPrimitive":
        # reconstruct in-memory TP records from the POD stride
        payload = wire_to_tps(buf[hdr_size:])
    elif payload_stride:
        if len(payload) % payload_stride:
            raise ValueError(f"payload {len(payload)} B not a multiple of "
                             f"stride {payload_stride}")
        payload = payload.reshape(-1, payload_stride)
    else:
        payload = payload.reshape(1, -1) if len(payload) else \
            payload.reshape(0, 0)
    header = FragmentHeader(
        run_number=int(h["run_number"]),
        trigger_number=int(h["trigger_number"]),
        trigger_timestamp=int(h["trigger_timestamp"]),
        window_begin=int(h["window_begin"]),
        window_end=int(h["window_end"]),
        source_id=int(h["elem_id"]), fragment_type=ftype,
        sequence_number=int(h["sequence_number"]),
        detector_id=int(h["detector_id"]),
        error_bits=int(h["error_bits"]), version=int(h["version"]),
        subsystem=Subsystem(int(h["elem_subsystem"])).name)
    return Fragment(header, payload.copy())


# ---- TPSet framing (framework binary; module docstring caveat) ---------

TPSET_MARKER = 0x54535054            # 'TPST' little-endian
TPSET_WIRE_VERSION = 1
TPSET_HEADER_DTYPE = np.dtype([
    ("marker", "<u4"), ("version", "<u4"),
    ("run_number", "<u4"), ("type", "<u4"),
    ("origin", "<u4"), ("seqno", "<u4"),
    ("start_time", "<u8"), ("end_time", "<u8"),
    ("n_objects", "<u4"), ("reserved", "<u4"),
])
assert TPSET_HEADER_DTYPE.itemsize == 48


def tpset_to_bytes(tpset: TPSet) -> bytes:
    hdr = np.zeros(1, dtype=TPSET_HEADER_DTYPE)
    h = hdr[0]
    h["marker"] = TPSET_MARKER
    h["version"] = TPSET_WIRE_VERSION
    h["run_number"] = tpset.run_number
    h["type"] = int(tpset.type)
    h["origin"] = tpset.origin
    h["seqno"] = tpset.seqno
    h["start_time"] = np.uint64(tpset.start_time)
    h["end_time"] = np.uint64(tpset.end_time)
    h["n_objects"] = len(tpset.objects)
    return hdr.tobytes() + tps_to_wire(tpset.objects)


def tpset_from_bytes(buf: bytes) -> TPSet:
    hs = TPSET_HEADER_DTYPE.itemsize
    if len(buf) < hs:
        raise ValueError(f"short TPSet: {len(buf)} B < {hs} B header")
    h = np.frombuffer(buf[:hs], dtype=TPSET_HEADER_DTYPE)[0]
    if int(h["marker"]) != TPSET_MARKER:
        raise ValueError(f"bad TPSet marker 0x{int(h['marker']):08x}")
    if int(h["version"]) != TPSET_WIRE_VERSION:
        raise ValueError(f"TPSet wire version {int(h['version'])} != "
                         f"{TPSET_WIRE_VERSION}")
    n = int(h["n_objects"])
    need = hs + n * TP_WIRE_DTYPE.itemsize
    if len(buf) < need:
        # a partial write at a 48-byte boundary would otherwise decode
        # silently short — lossy replay claiming to be lossless
        raise ValueError(f"truncated TPSet: header claims {n} TPs "
                         f"({need} B), got {len(buf)} B")
    tps = wire_to_tps(buf[hs:need])
    return TPSet(run_number=int(h["run_number"]),
                 type=TPSetType(int(h["type"])), origin=int(h["origin"]),
                 start_time=int(h["start_time"]),
                 end_time=int(h["end_time"]), seqno=int(h["seqno"]),
                 objects=tps)
