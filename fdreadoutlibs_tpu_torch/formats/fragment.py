"""Fragment records for data-request responses.

Port copy of ``fdreadoutlibs_tpu/formats/fragment.py:1-80``: the same code apart from
imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Mirrors the used subset of ``daqdataformats::Fragment``/``FragmentHeader``
(the reference's request handlers assemble fragment pieces into Fragments
upstream in readoutlibs; SURVEY.md §2.6): run/trigger identifiers, the
requested window, source id, fragment type, and the payload bytes.

``to_bytes``/``from_bytes`` round-trip the daqdataformats BINARY wire
layout (72-byte FragmentHeader POD + payload bytes — formats/wire.py), so
fragment files this framework writes carry the real upstream header, not a
framework-private record.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FRAGMENT_HEADER_VERSION = 5     # daqdataformats v4 series


@dataclass
class FragmentHeader:
    run_number: int = 0
    trigger_number: int = 0
    trigger_timestamp: int = 0
    window_begin: int = 0
    window_end: int = 0
    source_id: int = 0
    fragment_type: str = "kUnknown"
    sequence_number: int = 0
    detector_id: int = 0
    error_bits: int = 0
    version: int = FRAGMENT_HEADER_VERSION
    subsystem: str = "kDetectorReadout"    # SourceID.subsystem


@dataclass
class Fragment:
    header: FragmentHeader
    payloads: np.ndarray = field(default_factory=lambda: np.zeros((0, 0),
                                                                  np.uint8))

    @property
    def size_bytes(self) -> int:
        return int(self.payloads.nbytes)

    def __len__(self) -> int:
        return len(self.payloads)

    def to_bytes(self) -> bytes:
        """daqdataformats binary form: 72-byte header POD + payloads."""
        from .wire import pack_fragment
        return pack_fragment(self)

    @classmethod
    def from_bytes(cls, buf: bytes,
                   payload_stride: int | None = None) -> "Fragment":
        from .wire import unpack_fragment
        return unpack_fragment(buf, payload_stride=payload_stride)


def build_fragment(payloads: np.ndarray, *, run_number: int,
                   trigger_number: int, window_begin: int, window_end: int,
                   source_id: int, fragment_type: str,
                   trigger_timestamp: int | None = None,
                   sequence_number: int = 0,
                   subsystem: str = "kDetectorReadout",
                   detector_id: int = 0) -> Fragment:
    """Assemble a data-request response fragment from extracted payloads."""
    hdr = FragmentHeader(
        run_number=run_number, trigger_number=trigger_number,
        trigger_timestamp=(trigger_timestamp if trigger_timestamp is not None
                           else window_begin),
        window_begin=window_begin, window_end=window_end,
        source_id=source_id, fragment_type=fragment_type,
        sequence_number=sequence_number, subsystem=subsystem,
        detector_id=detector_id)
    return Fragment(hdr, np.asarray(payloads))
