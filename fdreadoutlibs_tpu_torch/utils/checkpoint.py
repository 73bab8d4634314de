"""Checkpoint / resume for streaming state.

Port copy of ``fdreadoutlibs_tpu/utils/checkpoint.py:1-94``, the npz half:
``save_state``, ``load_state`` and ``checkpoint_processor`` are the same
code; :func:`restore_processor` clears the device state the port's
processor carries, which is ``_dev_state`` on the WIBEth (and WIB2)
processor and ``_pallas_stack`` on the DAPHNE-stream processor, where the
JAX one clears ``_pallas_stack`` (:84).  ``checkpoint_processor`` reads the
state through ``current_state()``, so a state held on the card is fetched
first.  The sharded orbax half (``save_sharded_state``,
``load_sharded_state``) is not part of this module.

The reference has NO checkpointing — ChanState is re-seeded at every run
start (SURVEY.md §5).  Because this framework carries all streaming state
as explicit arrays (ChanState + processor bookkeeping), a checkpoint is a
single npz; a processor can resume mid-stream bit-exactly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.chanstate import ChanState

_META_KEYS = ("previous_ts", "previous_seq_id", "last_processed_daq_ts")
# the attributes that hold a processor's carried state on its device
_DEVICE_STATE = ("_dev_state", "_pallas_stack")


def save_state(path, state: dict, **meta) -> Path:
    """Save a ChanState-like dict of arrays (+ scalar metadata) to npz."""
    arrays = {f"state/{k}": np.asarray(v) for k, v in state.items()}
    arrays.update({f"meta/{k}": np.asarray(v) for k, v in meta.items()})
    np.savez_compressed(str(path), **arrays)
    return Path(path)


def load_state(path):
    """Returns (state dict, meta dict)."""
    blob = np.load(str(path))
    state, meta = {}, {}
    for k in blob.files:
        kind, name = k.split("/", 1)
        if kind == "state":
            state[name] = blob[k]
        else:
            v = blob[k]
            meta[name] = v.item() if v.shape == () else v
    return ChanState(state), meta


def checkpoint_processor(proc, path) -> Path:
    """Checkpoint a frame processor's full streaming context."""
    meta = {k: getattr(proc, k, 0) for k in _META_KEYS}
    meta["first_hit"] = getattr(proc, "_first_hit", True)
    if hasattr(proc, "current_state"):   # lazily-materialized device state
        state = proc.current_state() or {}
    else:
        state = getattr(proc, "_state", None) or {}
    if getattr(proc, "register_channels", None) is not None:
        meta["register_channels"] = np.asarray(proc.register_channels)
        meta["register_memory_factor"] = np.asarray(proc.register_memory_factor)
    return save_state(path, state, **meta)


def restore_processor(proc, path) -> None:
    """Restore a checkpoint into a conf()'d + start()'d processor; its
    device state is rebuilt from the restored one at the next batch."""
    state, meta = load_state(path)
    if len(state):
        proc._state = state
        for attr in _DEVICE_STATE:
            if hasattr(proc, attr):
                setattr(proc, attr, None)
        proc._state_stale = False
    for k in _META_KEYS:
        if k in meta:
            setattr(proc, k, int(meta[k]))
    if "register_channels" in meta:
        proc.register_channels = np.asarray(meta["register_channels"])
        proc.register_memory_factor = np.asarray(meta["register_memory_factor"])
        proc._first_hit = bool(meta.get("first_hit", False))
    proc._first_ts_check = False
    proc._first_seq_check = False
