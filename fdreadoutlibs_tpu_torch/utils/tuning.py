"""Kernel knobs of the port — counterpart of ``fdreadoutlibs_tpu/utils/tuning.py``.

Only ``tc`` (ticks per slot chunk) exists here.  It sets the hit capacity
(K hits per channel per tc ticks), so it is held equal to the JAX
package's ``pallas_tpg.SHIPPED_KNOBS`` per family and the two packages
drop the same hits.  The TPU's ``sub`` (sublane block) and ``unroll``
knobs have no meaning for the CUDA kernel and are not carried.
"""

from __future__ import annotations

from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig

from ..ops.xp import check_supported

KNOBS = {
    Algorithm.SIMPLE_THRESHOLD: {"tc": 512},
    Algorithm.ABS_RS: {"tc": 256},
    Algorithm.STANDARD_RS: {"tc": 512},
}


def kernel_knobs(cfg: TPGConfig) -> dict:
    """{"tc": ...} for ``cfg``'s family."""
    check_supported(cfg)
    return dict(KNOBS[cfg.algorithm])
