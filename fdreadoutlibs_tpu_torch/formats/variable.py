"""Variable-size payload adapter.

Port copy of ``fdreadoutlibs_tpu/formats/variable.py:1-52``
(numpy); the code is unchanged.

Equivalent of VariableSizePayloadTypeAdapter (include/fdreadoutlibs/
VariableSizePayloadTypeAdapter.hpp:26-36): a size + owned buffer wrapper for
payloads without a fixed frame geometry.  In numpy terms a batch is a list
of byte buffers plus a timestamp vector; the helpers below adapt such
batches to the latency-buffer record shape used by the request handlers.
"""

from __future__ import annotations

import numpy as np


class VariableSizePayload:
    """size + owned bytes (hpp:26-36), with an optional timestamp key."""

    __slots__ = ("data", "timestamp")

    def __init__(self, data: bytes, timestamp: int = 0):
        self.data = bytes(data)
        self.timestamp = int(timestamp)

    @property
    def size(self) -> int:
        return len(self.data)

    def get_first_timestamp(self) -> int:
        return self.timestamp

    def set_first_timestamp(self, ts: int) -> None:
        self.timestamp = int(ts)


def pack_batch(payloads: list[VariableSizePayload], max_size: int):
    """Fixed-stride view of a variable batch (zero-padded), for transport
    through the fixed-size buffer machinery: returns (records, sizes)."""
    dtype = np.dtype([("time_start", np.uint64), ("size", np.uint32),
                      ("payload", np.uint8, (max_size,))])
    recs = np.zeros(len(payloads), dtype=dtype)
    for i, p in enumerate(payloads):
        if p.size > max_size:
            raise ValueError(f"payload {i} exceeds max_size ({p.size} > {max_size})")
        recs["time_start"][i] = p.timestamp
        recs["size"][i] = p.size
        recs["payload"][i, :p.size] = np.frombuffer(p.data, dtype=np.uint8)
    return recs


def unpack_batch(recs: np.ndarray) -> list[VariableSizePayload]:
    return [VariableSizePayload(r["payload"][: r["size"]].tobytes(),
                                int(r["time_start"])) for r in recs]
