"""Checkpoint / resume for streaming state.

Port copy of ``fdreadoutlibs_tpu/utils/checkpoint.py:1-94``, the npz half:
``save_state``, ``load_state`` and ``checkpoint_processor`` are the same
code; :func:`restore_processor` clears the device state the port's
processor carries, which is ``_dev_state`` on the WIBEth (and WIB2)
processor and ``_pallas_stack`` on the DAPHNE-stream processor, where the
JAX one clears ``_pallas_stack`` (:84).  ``checkpoint_processor`` reads the
state through ``current_state()``, so a state held on the card is fetched
first.

The sharded half (:56-76, orbax there) is :func:`save_sharded_state` and
:func:`load_sharded_state` for a state split over a mesh
(``parallel.APAPipeline.state``, ``DetectorPipeline.state``): one npz a
shard and a JSON index of the grid and each shard's slices (its links), so
a checkpoint restores onto another shard count or device, as orbax
reshards onto ``like``'s sharding.

The reference has NO checkpointing — ChanState is re-seeded at every run
start (SURVEY.md §5).  Because this framework carries all streaming state
as explicit arrays (ChanState + processor bookkeeping), a checkpoint is a
single npz; a processor can resume mid-stream bit-exactly.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

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


def _pieces(v):
    """A state value -> (grid shape, its shards as numpy in grid order):
    a ``parallel.Sharded`` shard by shard, anything else one shard."""
    from ..parallel.mesh import Sharded
    if isinstance(v, Sharded):
        return v.shards.shape, [t.cpu().numpy() for t in v.shards.flat]
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return (1,), [np.asarray(v)]


def _slices(shapes: list, grid: tuple) -> tuple:
    """(each shard's [start, stop) along the split axes, the whole shape)
    from the shards' shapes in grid order; grid axis i splits array axis
    i."""
    cells = list(np.ndindex(grid))
    shape_of = dict(zip(cells, shapes))
    bounds = []
    for ax, n in enumerate(grid):
        edge = [shape_of[(0,) * ax + (i,) + (0,) * (len(grid) - ax - 1)][ax]
                for i in range(n)]
        bounds.append([0] + np.cumsum(edge).astype(int).tolist())
    whole = [b[-1] for b in bounds] + list(shapes[0][len(grid):])
    return [[[bounds[ax][i], bounds[ax][i + 1]] for ax, i in enumerate(cell)]
            for cell in cells], whole


def save_sharded_state(path, state: dict) -> None:
    """Checkpoint a state split over a mesh (e.g. ``APAPipeline.state``):
    ``path`` becomes a directory of one ``shard_<i>.npz`` a shard (every
    key's piece of that shard) and ``index.json`` naming the grid, each
    key's whole shape and dtype, and each shard's slices (its links).
    Completes the checkpoint story for multi-device runs (the reference
    has no checkpointing at all, let alone distributed)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    pieces = {k: _pieces(v) for k, v in state.items()}
    grids = {g for g, _ in pieces.values()}
    if len(grids) != 1:
        raise ValueError(f"the state's keys are split over grids {grids}")
    grid = grids.pop()
    index = {"grid": list(grid), "keys": {}, "shards": []}
    for k, (_, parts) in pieces.items():
        slices, whole = _slices([p.shape for p in parts], grid)
        index["keys"][k] = {"shape": whole, "dtype": str(parts[0].dtype),
                            "slices": slices}
    for i in range(int(np.prod(grid))):
        name = f"shard_{i:05d}.npz"
        np.savez(path / name, **{k: parts[i]
                                 for k, (_, parts) in pieces.items()})
        index["shards"].append(name)
    (path / "index.json").write_text(json.dumps(index))


def load_sharded_state(path, like: dict) -> dict:
    """Restore a sharded checkpoint onto ``like``'s devices and split (e.g.
    a freshly seeded ``APAPipeline.state``): each key is gathered from the
    shards' files and split again as ``like`` splits it, so a checkpoint of
    8 shards restores onto 1 or 2 shards and onto another device."""
    from ..parallel.mesh import Sharded
    path = Path(path)
    index = json.loads((path / "index.json").read_text())
    files = [np.load(path / name) for name in index["shards"]]
    out = {}
    for k, ref in like.items():
        meta = index["keys"][k]
        whole = np.zeros(meta["shape"], dtype=meta["dtype"])
        for f, sl in zip(files, meta["slices"]):
            whole[tuple(slice(a, b) for a, b in sl)] = f[k]
        if isinstance(ref, Sharded):
            grid = ref.shards.shape
            sl, _ = _slices([t.shape for t in ref.shards.flat], grid)
            out[k] = Sharded([torch.from_numpy(np.ascontiguousarray(
                whole[tuple(slice(a, b) for a, b in s)])).to(t.device)
                for s, t in zip(sl, ref.shards.flat)], grid)
        elif isinstance(ref, torch.Tensor):
            out[k] = torch.from_numpy(whole).to(ref.device)
        else:
            out[k] = whole
    return out


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
