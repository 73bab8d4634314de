"""The card's published peak and the least bytes a batch's trigger-
primitive generation moves, whatever implements it."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at the 700 W limit)
PEAK_HBM_BYTES_S = 3.35e12
SAMPLE_BITS = 14
STATE_WORDS_READ = 10        # the algorithm's 9 state fields + memory factor
STATE_WORDS_WRITTEN = 9
STATE_WORD_BYTES = 2         # int16-range values
HIT_RECORD_BYTES = 24        # channel, end, charge, tover, peak, peak time


def least_bytes(channels: int, ticks: int, hits: float, *,
                sample_bits: int = SAMPLE_BITS,
                state_words_read: int = STATE_WORDS_READ,
                state_words_written: int = STATE_WORDS_WRITTEN) -> float:
    """Samples read once at their wire width, the channel state read and
    written once, the hit records written once.  The defaults are a
    WIBEth AbsRS batch's; a system module states its frontend's."""
    return (channels * ticks * sample_bits / 8
            + channels * (state_words_read + state_words_written)
            * STATE_WORD_BYTES
            + hits * HIT_RECORD_BYTES)
