"""Kernel knobs of the port — counterpart of ``fdreadoutlibs_tpu/utils/tuning.py``.

The knobs are resolved as the JAX package resolves them (:60-111): an
explicit argument, then the tuned file named by ``FDREADOUT_TUNED`` (or
``path``) field by field, then the shipped table.  ``probes/autotune.py``
writes such a file on the card, as ``scripts/autotune.py`` writes one on a
TPU; either package reads either file.

The launch knobs:

* ``tc`` (ticks per slot chunk) sets the hit capacity (K hits per channel
  per tc ticks), so the shipped value equals the JAX package's
  (``pallas_tpg.SHIPPED_KNOBS``, :133-139) and the two packages drop the
  same hits;
* ``k_slots`` (the tuned ``k``) is the performance default of the probes
  and the tuner.  As in the JAX package (:70-76) the streaming processors
  keep their configured capacity: a speed-tuned k never cuts it;
* ``fir_twopass`` selects the FIR schedule: 0 the fused tick (K3), 1 the
  two-pass schedule, 2 two-pass with lifted emission (both K5).

The geometry of the pipeline (``csrc/tpg.cuh``), one kernel library per
geometry; none of the three changes a hit:

* ``group`` (``kGroup``), ticks per unrolled group of each warp's loop,
  the counterpart of the TPU's ``unroll``; a multiple of 8 (the FIR ring
  is 8 registers addressed by constant indices, ``tpg.cuh:55-58``);
* ``stage_ticks`` (``kPipeTicks``), ticks per stage of the shared-memory
  ring, a multiple of ``group``;
* ``stages`` (``kPipeStages``), the ring's depth, at least 2 (the loader
  runs a stage ahead).  ``stage_ticks`` x ``stages`` is the counterpart of
  the Pallas time block in VMEM; the block's shared memory (the ring's
  slabs and its mbarriers, :func:`shared_bytes`) must stay within
  ``kMaxSharedBytes``.

The TPU's ``sub`` (channels per block) has no counterpart: a block is one
warp of 32 lanes, one channel's serial chain each (``kPipeLanes``).  The
port ignores ``sub`` and ``unroll`` in a tuned file, as the JAX package
ignores ``group``, ``stage_ticks`` and ``stages``, so one file stays safe
to deploy in both.  A geometry that breaks a rule falls back field by
field, with a warning, as the JAX package's ``sub`` does (:94-100).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

from ..ops.config import Algorithm, TPGConfig
from ..ops.xp import check_supported
from .logging import log

_ENV = "FDREADOUT_TUNED"
_cache: dict[tuple, dict] = {}


class Geometry(NamedTuple):
    """The pipeline's compile-time shape (``TPG_GROUP``,
    ``TPG_PIPE_TICKS``, ``TPG_PIPE_STAGES``)."""
    group: int = 16
    stage_ticks: int = 32
    stages: int = 4


SHIPPED_GEOMETRY = Geometry()

KNOBS = {
    Algorithm.SIMPLE_THRESHOLD: {"tc": 512, "k": 1},
    Algorithm.ABS_RS: {"tc": 256, "k": 1},
    Algorithm.STANDARD_RS: {"tc": 512, "k": 1},
    Algorithm.FIR: {"tc": 256, "k": 1, "fir_twopass": 0},
}

# csrc/tpg.cuh: kPipeLanes, kMaxSharedBytes, kMbarrierBytes, and the
# mbarriers a stage takes (kPipeBars = 5 * kPipeStages)
PIPE_LANES = 32
MAX_SHARED_BYTES = 232448
_BARS_PER_STAGE = 5
_MBARRIER_BYTES = 8
# the encodings of tpg.cuh's pipe_slabs; the slab unpack adds one slab
ENCODINGS = ("plain", "time2", "packed14", "gather14", "slab14", "plain16")


def pipe_slabs(family: Algorithm, encoding: str = "plain",
               peaks: bool = True, fir_twopass: int = 0) -> int:
    """Slabs of one ring stage (``tpg.cuh::pipe_slabs``): the feed; s and
    sigma (K3); K5's s, sigma, flags, to_add and filt with peaks; s and the
    RS warp's flags (the threshold mode; SimpleThreshold no flags); one more
    for the slab unpack's time2 slab."""
    if encoding not in ENCODINGS:
        raise ValueError(f"encoding {encoding!r}: expected one of "
                         f"{ENCODINGS}")
    if family == Algorithm.FIR:
        slabs = 5 + int(peaks) if fir_twopass else 3
    else:
        slabs = 2 if family == Algorithm.SIMPLE_THRESHOLD else 3
    return slabs + int(encoding == "slab14" and not fir_twopass)


def shared_bytes(geometry: Geometry, family: Algorithm,
                 encoding: str = "plain", peaks: bool = True,
                 fir_twopass: int = 0) -> int:
    """Shared memory of one block of the pipeline at ``geometry``, as the
    launch counts it against ``kMaxSharedBytes`` (``tpg.cuh::
    fused_shared_bytes`` without the carry layout's staging): the ring's
    slabs of ``stage_ticks`` x 32 int32 words a stage, and its
    mbarriers."""
    slabs = pipe_slabs(family, encoding, peaks, fir_twopass)
    return (4 * slabs * geometry.stages * geometry.stage_ticks * PIPE_LANES
            + _BARS_PER_STAGE * geometry.stages * _MBARRIER_BYTES)


def geometry_problem(geometry: Geometry, family: Algorithm,
                     encoding: Optional[str] = None, peaks: bool = True,
                     fir_twopass: int = 0) -> Optional[str]:
    """Why ``geometry`` cannot be built or launched for this family, or
    None.  ``encoding`` None checks every encoding the family runs (the
    slab unpack's extra slab included)."""
    g = geometry
    if g.group < 1 or g.group % 8:
        return f"group={g.group} is not a multiple of 8 (the FIR ring)"
    if g.stage_ticks < 1 or g.stage_ticks % g.group:
        return (f"stage_ticks={g.stage_ticks} is not a multiple of "
                f"group={g.group}")
    if g.stages < 2:
        return f"stages={g.stages}: the ring needs 2 or more"
    encs = ENCODINGS if encoding is None else (encoding,)
    need = max(shared_bytes(g, family, e, peaks, fir_twopass) for e in encs)
    if need > MAX_SHARED_BYTES:
        return (f"{tuple(g)} needs {need} B of shared memory a block > "
                f"{MAX_SHARED_BYTES} B")
    return None


def load_tuned(path: Optional[str] = None) -> dict:
    """{algorithm_name: {field: value}} from ``path`` or the
    ``FDREADOUT_TUNED`` file; {} when neither is set, or the file is
    unreadable or not a JSON object (a tuned file must always be safe to
    deploy).  Cached per (path, mtime), so a rewritten file is picked up
    on the next call."""
    path = path or os.environ.get(_ENV)
    if not path:
        return {}
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    key = (path, mtime)
    if key not in _cache:
        try:
            with open(path) as f:
                data = json.load(f)
            _cache[key] = data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            log.warning("ignoring unreadable tuned-config file %s", path)
            _cache[key] = {}
    return _cache[key]


def _tuned_int(tuned: dict, key: str, minimum: int):
    """A tuned field, or None when absent or malformed (bad fields fall
    back one by one)."""
    v = tuned.get(key)
    if isinstance(v, bool) or not isinstance(v, int) or v < minimum:
        if v is not None:
            log.warning("ignoring tuned %s=%r (not an int >= %d)",
                        key, v, minimum)
        return None
    return v


def _geometry(tuned: dict, cfg: TPGConfig, fir_twopass: int) -> Geometry:
    """The tuned geometry over the shipped one, field by field: a field
    that breaks a rule of :func:`geometry_problem` goes back to its
    shipped value, with a warning (a group that is no multiple of 8; a
    ring of fewer than 2 stages; a stage that is no whole number of groups:
    stage_ticks, then group; a ring over the shared memory: stages, then
    stage_ticks, the shipped pair always fitting), for every encoding the
    family runs."""
    ship = SHIPPED_GEOMETRY
    g = Geometry(*(v if v is not None else s for v, s in zip(
        (_tuned_int(tuned, "group", 1), _tuned_int(tuned, "stage_ticks", 1),
         _tuned_int(tuned, "stages", 1)), ship)))

    def back(field: str, why: str) -> None:
        nonlocal g
        log.warning("ignoring tuned %s=%r for %s: %s", field,
                    getattr(g, field), cfg.algorithm.value, why)
        g = g._replace(**{field: getattr(ship, field)})

    def whole_groups() -> None:
        for field in ("stage_ticks", "group"):
            if g.stage_ticks % g.group and \
                    getattr(g, field) != getattr(ship, field):
                back(field, f"stage_ticks={g.stage_ticks} is not a multiple "
                     f"of group={g.group}")

    if g.group % 8:
        back("group", "not a multiple of 8 (the FIR ring)")
    if g.stages < 2:
        back("stages", "the ring needs 2 or more")
    whole_groups()
    for field in ("stages", "stage_ticks"):
        why = geometry_problem(g, cfg.algorithm, None, cfg.track_peaks,
                               fir_twopass)
        if why is None:
            break
        if getattr(g, field) != getattr(ship, field):
            back(field, why)
            whole_groups()
    return g


def kernel_knobs(cfg: TPGConfig, tc: Optional[int] = None,
                 path: Optional[str] = None) -> dict:
    """The launch knobs of ``cfg``'s family: ``tc`` (the explicit argument,
    else the tuned field, else the shipped value), ``k_slots``,
    ``fir_twopass`` (0 for every family but FIR; a tuned value above 2
    means 2, as the JAX kernel takes any value >= 2 as the lifted
    schedule), and ``geometry``, a :class:`Geometry` (``group``,
    ``stage_ticks``, ``stages``; what ``tpg.process_window`` takes),
    checked for every encoding the family runs."""
    check_supported(cfg)
    shipped = KNOBS[cfg.algorithm]
    tuned = load_tuned(path).get(cfg.algorithm.value, {})
    if not isinstance(tuned, dict):
        tuned = {}
    t_tc = _tuned_int(tuned, "tc", 1)
    t_k = _tuned_int(tuned, "k", 1)
    twopass = _tuned_int(tuned, "twopass", 0) if "fir_twopass" in shipped \
        else None
    twopass = min(twopass, 2) if twopass is not None \
        else shipped.get("fir_twopass", 0)
    return {"tc": tc if tc is not None else
            (t_tc if t_tc is not None else shipped["tc"]),
            "k_slots": t_k if t_k is not None else shipped["k"],
            "fir_twopass": twopass,
            "geometry": _geometry(tuned, cfg, twopass)}
