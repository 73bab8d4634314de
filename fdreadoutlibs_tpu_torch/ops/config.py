"""TPG algorithm configuration.

Copied from ``fdreadoutlibs_tpu/ops/config.py:1-121``; only the error
import differs (the port's ``stream.errors``).

Mirrors the knobs of ``readoutlibs::readoutconfig::RawDataProcessorConf``
consumed in WIBEthFrameProcessor::conf (src/wibeth/WIBEthFrameProcessor.cpp:
173-235), pre-scaled the same way:

* ``rs_memory_factor_x10``  = 10 * tpg_rs_memory_factor   (cpp:202)
* ``rs_scale_factor_x10``   = 10 / tpg_rs_scale_factor    (cpp:206)

Semantics flags document known divergences between the reference's naive and
AVX2 kernels; the production default reproduces the *deployed* (AVX2)
behavior:

* ``peak_gated`` — naive updates hit_peak_adc only while over threshold
  (ProcessNaive.hpp:100-103); AVX2 updates it unconditionally
  (ProcessAVX2.hpp:134-136).  Default False (AVX2).
* ``rs_float`` — ProcessNaiveRS uses float R=0.8/scale=2 with round()
  (ProcessNaiveRS.hpp:26-27, 97-103); the AVX2 RS kernels use x10 integer
  fixed point with mulhrs division.  Default False (AVX2 fixed point).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Algorithm(str, Enum):
    SIMPLE_THRESHOLD = "SimpleThreshold"
    ABS_RS = "AbsRS"
    STANDARD_RS = "StandardRS"
    FIR = "FIR"                     # WIB/WIB2 legacy FIR+IQR family


@dataclass(frozen=True)
class TPGConfig:
    algorithm: Algorithm = Algorithm.SIMPLE_THRESHOLD
    threshold: int = 2000                       # swtpg_wibeth::THRESHOLD default
    accumulator_limit: int = 10                 # frugal_streaming_accumulator_limit
    rs_memory_factor_x10: int = 8               # 10 * 0.8
    rs_scale_factor_x10: int = 5                # 10 / 2
    # FIR family (wib/wib2): firwin_int(7, 0.1, 2**tap_exponent) + trailing 0
    tap_exponent: int = 6
    n_taps: int = 8
    taps: tuple | None = None           # None -> firwin_int(7,0.1,mult)+(0,)
    # semantics flags (see module docstring and ops/fir.py)
    peak_gated: bool = False
    rs_float: bool = False
    fir_avx_semantics: bool = True
    # FIR family: the reference kernels emit 4-field records with no peak
    # tracking (wib/wib2 TP assembly derives time_peak = (begin+end)/2 and
    # adc_peak = charge/20, WIB2FrameProcessor.cpp:420-460) — disabling the
    # superset peak registers trims the hot loop for those pipelines.
    track_peaks: bool = True
    # Kernel specialization hint: a static promise that every per-channel
    # rs_memory_factor value is 0 or (1 << rs_mf_shift), which lets the hot
    # kernels replace the per-tick vector multiply with a masked shift —
    # bit-exact where the promise holds (property-tested vs the generic
    # path).  The production configs qualify: rs_memory_factor=0.8 -> x10
    # value 8 = 1<<3, and threshold-on-collection zeroes collection
    # channels (WIBEthFrameProcessor.cpp:441-450).  None = generic multiply.
    rs_mf_shift: int | None = None

    def check_memory_factors(self, rs_memory_factor) -> None:
        """Validate per-channel memory factors against the ``rs_mf_shift``
        promise ({0, 1 << shift}) — the shift-specialized kernels would
        silently compute wrong RS values otherwise.  Called by every path
        that seeds per-channel factors."""
        if self.rs_mf_shift is None:
            return
        import numpy as np
        allowed = {0, 1 << self.rs_mf_shift}
        values = set(np.unique(np.asarray(rs_memory_factor)).tolist())
        if not values <= allowed:
            raise ValueError(
                f"rs_mf_shift={self.rs_mf_shift} promises per-channel "
                f"memory factors in {sorted(allowed)}, got "
                f"{sorted(values)}; build the config with rs_mf_shift=None "
                "for arbitrary factors")

    @property
    def multiplier(self) -> int:
        return 1 << self.tap_exponent

    @property
    def adc_max(self) -> int:
        return 32767 // self.multiplier

    @staticmethod
    def from_raw(algorithm: str = "SimpleThreshold", threshold: int = 2000,
                 rs_memory_factor: float = 0.8, rs_scale_factor: float = 2.0,
                 frugal_streaming_accumulator_limit: int = 10, **kw) -> "TPGConfig":
        """Build from reference-style raw config values (conf() scaling)."""
        try:
            alg = Algorithm(algorithm)
        except ValueError:
            # the reference throws TPGAlgorithmInexistent
            # (WIBEthFrameProcessor.cpp:195-197)
            from ..stream.errors import TPGAlgorithmInexistent
            raise TPGAlgorithmInexistent(
                f"unknown TPG algorithm {algorithm!r} "
                f"(available: {[a.value for a in Algorithm]})") from None
        # NOTE: track_peaks deliberately stays True here even for FIR —
        # some consumers (DAPHNE PDS) assemble TPs from the peak fields.
        # The WIB/WIB2 processors, whose TP assembly derives peaks as
        # (begin+end)/2 and charge/20 like the reference, opt in to
        # track_peaks=False themselves.
        mf_x10 = int(10 * rs_memory_factor)
        if "rs_mf_shift" not in kw and mf_x10 > 0 and \
                mf_x10 & (mf_x10 - 1) == 0:
            # power-of-two memory factor: enable the masked-shift kernel
            # specialization (bit-exact; see rs_mf_shift field docs)
            kw["rs_mf_shift"] = mf_x10.bit_length() - 1
        return TPGConfig(
            algorithm=alg,
            threshold=int(threshold),
            accumulator_limit=int(frugal_streaming_accumulator_limit),
            rs_memory_factor_x10=mf_x10,
            rs_scale_factor_x10=int(10 / rs_scale_factor),
            **kw,
        )
