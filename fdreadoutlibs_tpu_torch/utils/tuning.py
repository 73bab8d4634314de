"""Kernel knobs of the port — counterpart of ``fdreadoutlibs_tpu/utils/tuning.py``.

Two knobs exist here, resolved as the JAX package resolves them: the tuned
file named by ``FDREADOUT_TUNED`` (or ``path``), field by field, over the
shipped table (``pallas_tpg.SHIPPED_KNOBS``, :133-139).

* ``tc`` (ticks per slot chunk) sets the hit capacity (K hits per channel
  per tc ticks), so it is held equal to the JAX package's and the two
  packages drop the same hits;
* ``fir_twopass`` selects the FIR schedule: 0 the fused tick (K3), 1 the
  two-pass schedule, 2 two-pass with lifted emission (both K5).  Shipped 0;
  a tuned file's ``{"FIR": {"twopass": 1 or 2}}`` selects K5 in every FIR
  caller of the port, as it does in the JAX package (tuning.py:100-111).

The TPU's ``sub`` (sublane block), ``unroll`` and ``k`` knobs have no
meaning for the CUDA kernels and are not read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..ops.config import Algorithm, TPGConfig
from ..ops.xp import check_supported
from .logging import log

_ENV = "FDREADOUT_TUNED"
_cache: dict[tuple, dict] = {}

KNOBS = {
    Algorithm.SIMPLE_THRESHOLD: {"tc": 512},
    Algorithm.ABS_RS: {"tc": 256},
    Algorithm.STANDARD_RS: {"tc": 512},
    Algorithm.FIR: {"tc": 256, "fir_twopass": 0},
}


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


def kernel_knobs(cfg: TPGConfig, path: Optional[str] = None) -> dict:
    """{"tc", "fir_twopass"} for ``cfg``'s family: the tuned file's
    well-formed fields over the shipped table.  ``fir_twopass`` is 0 for
    every family but FIR; a tuned value above 2 means 2 (the JAX kernel
    takes any value >= 2 as the lifted schedule)."""
    check_supported(cfg)
    shipped = KNOBS[cfg.algorithm]
    tuned = load_tuned(path).get(cfg.algorithm.value, {})
    if not isinstance(tuned, dict):
        tuned = {}
    tc = _tuned_int(tuned, "tc", 1)
    twopass = _tuned_int(tuned, "twopass", 0) if "fir_twopass" in shipped \
        else None
    return {"tc": tc if tc is not None else shipped["tc"],
            "fir_twopass": min(twopass, 2) if twopass is not None
            else shipped.get("fir_twopass", 0)}
