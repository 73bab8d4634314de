"""Fragment recording: persist data-request responses.

Port copy of ``fdreadoutlibs_tpu/tp/recorder.py:1-93``: the same code apart from
imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

The DAQ's dataflow tier writes Fragments into run files (dfmodules/HDF5
upstream of the reference).  This recorder closes the request->record loop
inside the framework: fragments append to a simple self-describing
directory store (one ``.frag`` binary per fragment — the daqdataformats
wire layout, 72-byte FragmentHeader POD + payload bytes (formats/wire.py),
readable by any tool that knows the upstream POD — plus a JSONL index),
and can be read back as Fragment objects for offline checks.  Stores
written by earlier rounds (one npz per fragment) stay readable.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..formats.fragment import Fragment, FragmentHeader


class FragmentRecorder:
    """Append-only fragment store for a run."""

    def __init__(self, directory, run_number: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.run_number = run_number
        self._index = self.dir / "index.jsonl"
        self._n = sum(1 for _ in open(self._index)) \
            if self._index.exists() else 0

    def write(self, fragment: Fragment) -> Path:
        name = f"run{self.run_number:06d}_frag{self._n:08d}.frag"
        path = self.dir / name
        path.write_bytes(fragment.to_bytes())
        meta = {k: getattr(fragment.header, k)
                for k in ("run_number", "trigger_number", "trigger_timestamp",
                          "window_begin", "window_end", "source_id",
                          "fragment_type", "sequence_number", "detector_id",
                          "error_bits", "version", "subsystem")}
        meta["file"] = name
        meta["n_payloads"] = len(fragment)
        meta["size_bytes"] = fragment.size_bytes
        if fragment.payloads.dtype.names:
            # structured payloads (e.g. ring-retention records with a
            # time_start field): the .frag bytes are dtype-less, so the
            # index carries the descr for faithful read()-back
            meta["payload_dtype"] = fragment.payloads.dtype.descr
        with open(self._index, "a") as f:
            f.write(json.dumps(meta) + "\n")
        self._n += 1
        return path

    def __len__(self) -> int:
        return self._n

    def read(self, index: int) -> Fragment:
        with open(self._index) as f:
            for i, line in enumerate(f):
                if i == index:
                    meta = json.loads(line)
                    break
            else:
                raise IndexError(index)
        path = self.dir / meta["file"]
        if path.suffix == ".npz":           # pre-round-5 store compat
            payloads = np.load(path)["payloads"]
            hdr = FragmentHeader(
                **{k: v for k, v in meta.items()
                   if k in FragmentHeader.__dataclass_fields__})
            return Fragment(hdr, payloads)
        n = int(meta.get("n_payloads", 0))
        stride = (meta["size_bytes"] // n
                  if n and meta["fragment_type"] != "kTriggerPrimitive"
                  else None)
        frag = Fragment.from_bytes(path.read_bytes(), payload_stride=stride)
        if "payload_dtype" in meta and n:
            # restore the structured dtype the writer recorded (descr
            # round-trips through JSON as lists; shapes need tuples)
            dt = np.dtype([tuple(f) if len(f) < 3 else
                           (f[0], f[1], tuple(f[2]))
                           for f in meta["payload_dtype"]])
            frag = Fragment(frag.header,
                            np.ascontiguousarray(frag.payloads)
                            .view(dt).reshape(n))
        return frag

    def index(self) -> list[dict]:
        if not self._index.exists():
            return []
        return [json.loads(line) for line in open(self._index)]
