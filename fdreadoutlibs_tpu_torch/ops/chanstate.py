"""Persistent per-channel streaming state (the reference's ChanState).

Copied from ``fdreadoutlibs_tpu/ops/chanstate.py:1-86``; the code is
unchanged.

Mirrors swtpg_wibeth::ChanState (wibeth/tpg/ProcessingInfo.hpp:20-66) plus the
FIR family's ``prev_samp`` circular buffer (wib2/tpg/ProcessingInfo.hpp:42).
Stored as a flat dict of (..., C) int32 arrays, trivially checkpointable.

Field order is the contract between the reference, the plain version and
the kernel (``ops/tpg.py`` state rows).
"""

from __future__ import annotations

import numpy as np

# Core fields: name -> index. Shapes are (..., C) int32 holding i16-range values.
FIELDS = (
    "pedestals",       # frugal-streaming pedestal median
    "accum",           # its accumulator
    "rs",              # running-sum value (x10 fixed point)
    "pedestals_rs",    # second pedestal (on the RS waveform)
    "accum_rs",        # its accumulator
    "prev_was_over",   # was the previous sample over threshold (0/1 mask)
    "hit_charge",      # integrated charge of the open hit
    "hit_tover",       # time over threshold so far
    "hit_peak_adc",    # peak ADC of the open hit
    "hit_peak_time",   # tover at the time of peak
    "quantile25",      # IQR lower quantile (FIR family)
    "quantile75",      # IQR upper quantile
    "accum25",
    "accum75",
)
NSTATE = len(FIELDS)


class ChanState(dict):
    """dict-of-arrays state; also carries per-channel RS memory factor and
    the FIR circular buffer when the FIR family is in use."""

    @property
    def n_channels(self) -> int:
        return self["pedestals"].shape[-1]

    def copy(self) -> "ChanState":
        return ChanState({k: np.copy(v) if isinstance(v, np.ndarray) else v
                          for k, v in self.items()})

    def as_stack(self, np_mod=np):
        """Stack core fields into a (NSTATE, ..., C) array (kernel I/O layout)."""
        return np_mod.stack([self[f] for f in FIELDS], axis=0)

    @classmethod
    def from_stack(cls, stack, extras: dict | None = None) -> "ChanState":
        st = cls({f: stack[i] for i, f in enumerate(FIELDS)})
        if extras:
            st.update(extras)
        return st


def init_chanstate(n_channels: int, n_taps: int = 8, xp=np, dtype=None) -> ChanState:
    """Zero-initialized state (ChanState constructor, ProcessingInfo.hpp:23-40)."""
    dtype = dtype or xp.int32
    st = ChanState({f: xp.zeros(n_channels, dtype=dtype) for f in FIELDS})
    st["rs_memory_factor"] = xp.zeros(n_channels, dtype=dtype)
    st["fir_prev"] = xp.zeros((n_taps, n_channels), dtype=dtype)
    st["fir_phase"] = xp.zeros((), dtype=dtype) if xp is not np else 0
    return st


def seed_chanstate(state: ChanState, first_samples, rs_memory_factor) -> ChanState:
    """ProcessingInfo::setState (wibeth/tpg/ProcessingInfo.hpp:100-148):
    pedestal := the channel's first ADC sample; quantiles := pedestal -/+ 20;
    RS state zeroed; per-channel RS memory factor installed (enables
    threshold-on-collection / RS-on-induction mixing,
    WIBEthFrameProcessor.cpp:441-450)."""
    st = state.copy() if isinstance(state.get("pedestals"), np.ndarray) else ChanState(dict(state))
    first = np.asarray(first_samples, dtype=np.int32)
    st["pedestals"] = first.copy()
    st["quantile25"] = first - 20
    st["quantile75"] = first + 20
    st["pedestals_rs"] = np.zeros_like(first)
    st["rs"] = np.zeros_like(first)
    st["rs_memory_factor"] = np.broadcast_to(
        np.asarray(rs_memory_factor, dtype=np.int32), first.shape).copy()
    return st
