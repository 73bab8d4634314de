"""Torch array namespace for the shared SWTPG tick.

``ops/step.py::dispatch_tick`` (``step.tpg_tick`` for the threshold/RS
families, ``fir.tpg_tick_fir`` for FIR; the port's copies of the JAX
package's modules) is written once against an array namespace ``xp`` and
a fixed-point helper ``fx`` (``fixedpoint.I32Fx.make`` or
``fixedpoint.I16Fx.make``).  :class:`TorchXP` is the namespace for integer
torch tensors on one device, so the port runs the same tick unchanged as
the numpy oracle and as the plain version of its hand-written kernels, and
:func:`make_fx` builds the fixed-point helper over it.

A namespace has a dtype: int32 (the emulated int16 arithmetic of I32Fx) or
int16 (the native int16 state mode, I16Fx, the plain version of K2b).  A
python int that the tick hands to ``where``/``minimum``/``maximum`` takes
the dtype of the tensor beside it, or the namespace's when there is none,
as a weakly typed scalar does in jnp; so every intermediate keeps the dtype
the JAX package computes in.
"""

from __future__ import annotations

import torch

from .config import TPGConfig
from .fixedpoint import I16Fx, I32Fx

DTYPES = (torch.int32, torch.int16)


def check_supported(cfg: TPGConfig, state: torch.Tensor | None = None) -> None:
    """Refuse a state the tick has no arithmetic for (never approximate)."""
    if state is not None and state.dtype not in DTYPES:
        raise ValueError(f"state must be int32 or int16, got {state.dtype}")


class TorchXP:
    """The subset of the numpy/jnp namespace the tick uses, over integer
    tensors of ``dtype`` (int32 or int16) on ``device``."""

    def __init__(self, device, dtype=torch.int32):
        if dtype not in DTYPES:
            raise ValueError(f"TorchXP takes int32 or int16, not {dtype}")
        self.device = torch.device(device)
        self.dtype = dtype

    def int32(self, v) -> torch.Tensor:
        return torch.full((), int(v), dtype=torch.int32, device=self.device)

    def int16(self, v) -> torch.Tensor:
        return torch.full((), int(v), dtype=torch.int16, device=self.device)

    def _pair(self, a, b):
        """Both operands as tensors; a python int takes its partner's
        dtype (the namespace's when both are ints)."""
        like = a if isinstance(a, torch.Tensor) else \
            b if isinstance(b, torch.Tensor) else None
        dtype = like.dtype if like is not None and \
            not like.dtype.is_floating_point and like.dtype != torch.bool \
            else self.dtype

        def t(v):
            return v if isinstance(v, torch.Tensor) else torch.full(
                (), int(v), dtype=dtype, device=self.device)
        return t(a), t(b)

    def where(self, cond, a, b):
        return torch.where(cond, *self._pair(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._pair(a, b))

    def maximum(self, a, b):
        return torch.maximum(*self._pair(a, b))

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def abs(x):
        return torch.abs(x)

    @staticmethod
    def trunc(x):
        return torch.trunc(x)

    @staticmethod
    def copysign(a, b):
        return torch.copysign(torch.full_like(b, a), b)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def concatenate(arrays, axis=0):
        return torch.cat(list(arrays), dim=axis)


def make_fx(xp: TorchXP):
    """The fixed-point helper of the namespace's dtype: ``I32Fx`` (int32
    tensors holding int16-range values with explicit wrap emulation) or
    ``I16Fx`` (native int16 tensors)."""
    return (I16Fx if xp.dtype == torch.int16 else I32Fx).make(xp)
