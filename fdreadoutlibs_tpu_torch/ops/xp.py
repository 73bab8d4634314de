"""Torch array namespace for the shared SWTPG tick.

``fdreadoutlibs_tpu.ops.step.tpg_tick`` is written once against an array
namespace ``xp`` and a fixed-point helper ``fx`` (``fixedpoint.I32Fx.make``);
numpy, XLA and Pallas all run that one function.  :class:`TorchXP` is the
namespace for int32 torch tensors on one device, so the port runs the same
tick unchanged (one source of tick semantics for every backend) as the plain
version of its hand-written kernel, and :func:`make_fx` builds the I32Fx
helper over it.

Scalars that ``tpg_tick`` hands to ``where``/``minimum``/``maximum`` as
python ints stay int32, so every intermediate keeps the int32 dtype the JAX
package computes in.  The float RS variant (``rs_float=True``) and the FIR
family are refused by :func:`check_supported`: ``step.py`` needs
``.astype`` for the former, and the FIR tick (K3) is not ported yet.
"""

from __future__ import annotations

import torch

from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops.fixedpoint import I32Fx

SUPPORTED = (Algorithm.SIMPLE_THRESHOLD, Algorithm.ABS_RS,
             Algorithm.STANDARD_RS)


def check_supported(cfg: TPGConfig) -> None:
    """Refuse configurations the port does not run (never approximate)."""
    if cfg.algorithm not in SUPPORTED:
        raise NotImplementedError(
            f"{cfg.algorithm.value} is not ported to torch yet (the FIR "
            "tick, K3 in ROADMAP.md); supported: "
            f"{[a.value for a in SUPPORTED]}")
    if cfg.rs_float:
        raise NotImplementedError(
            "rs_float=True (the naive float running sum) is not ported: "
            "ops/step.py needs .astype for it; use the x10 fixed point")


class TorchXP:
    """The subset of the numpy/jnp namespace ``tpg_tick`` uses, over int32
    tensors on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def int32(self, v) -> torch.Tensor:
        return torch.full((), int(v), dtype=torch.int32, device=self.device)

    def _t(self, v):
        return v if isinstance(v, torch.Tensor) else self.int32(v)

    def where(self, cond, a, b):
        return torch.where(cond, self._t(a), self._t(b))

    def minimum(self, a, b):
        return torch.minimum(self._t(a), self._t(b))

    def maximum(self, a, b):
        return torch.maximum(self._t(a), self._t(b))

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def abs(x):
        return torch.abs(x)


def make_fx(xp: TorchXP):
    """``fixedpoint.I32Fx.make`` over the torch namespace: int32 tensors
    holding int16-range values with explicit wrap emulation."""
    return I32Fx.make(xp)
