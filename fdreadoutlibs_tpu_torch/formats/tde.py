"""TDE16 (vertical-drift top-electronics) frame format.

Port copy of ``fdreadoutlibs_tpu/formats/tde.py:1-114``: the same code apart from
imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Geometry (reference: include/fdreadoutlibs/TDEFrameTypeAdapter.hpp,
src/tde/TDEFrameProcessor.cpp, test/apps/tde_file_creator.cxx): one frame
carries ONE channel's long sample block; frames from 64 channels interleave
on a link, so ordering is by (timestamp, channel)
(TDEFrameTypeAdapter.hpp:27-36) and the processor keeps a *per-channel*
previous-timestamp array (TDEFrameProcessor.cpp:34-77).

Layout: DAQEthHeader (2 x 64-bit words, same bitfields as WIBEth) +
TDE16Header (1 x 64-bit word: version:4, channel:6, adc_version:6,
reserved:48) + ``TOT_ADC16_SAMPLES`` x 16-bit samples.  The sample count and
tick spacing are the fddetdataformats constants
(``ticks_between_adc_samples * tot_adc16_samples`` drives the adapter's
expected_tick_difference, TDEFrameTypeAdapter.hpp:88); they are module
constants here so alternate firmware geometries can be configured.
"""

from __future__ import annotations

import numpy as np

from .wibeth import DAQ_HEADER_FIELDS  # same DAQEthHeader bitfields

TICKS_BETWEEN_ADC_SAMPLES = 32
TOT_ADC16_SAMPLES = 5965
EXPECTED_TICK_DIFFERENCE = TICKS_BETWEEN_ADC_SAMPLES * TOT_ADC16_SAMPLES
HEADER_BYTES = 24                      # DAQEthHeader (16) + TDE16Header (8)
FRAME_SIZE = HEADER_BYTES + 2 * TOT_ADC16_SAMPLES
N_CHANNELS_PER_LINK = 64
FRAGMENT_TYPE = "kTDE_AMC"

TDE_HEADER_FIELDS = {
    "tde_version": (0, 4),
    "channel": (4, 6),
    "adc_version": (10, 6),
}


def empty_frames(n: int = 1) -> np.ndarray:
    return np.zeros((n, FRAME_SIZE), dtype=np.uint8)


def _words64(frames: np.ndarray) -> np.ndarray:
    assert frames.shape[-1] == FRAME_SIZE
    return frames[..., :HEADER_BYTES].view("<u8")


def get_timestamp(frames: np.ndarray) -> np.ndarray:
    return _words64(frames)[..., 1].copy()


def set_timestamp(frames: np.ndarray, ts) -> None:
    _words64(frames)[..., 1] = np.asarray(ts, dtype=np.uint64)


def get_daq_header_field(frames: np.ndarray, name: str) -> np.ndarray:
    lsb, width = DAQ_HEADER_FIELDS[name]
    w0 = _words64(frames)[..., 0]
    return ((w0 >> np.uint64(lsb)) & np.uint64((1 << width) - 1)).astype(np.int64)


def set_daq_header_field(frames: np.ndarray, name: str, value) -> None:
    lsb, width = DAQ_HEADER_FIELDS[name]
    w = _words64(frames)
    mask = np.uint64(((1 << width) - 1) << lsb)
    v = (np.asarray(value, dtype=np.uint64) << np.uint64(lsb)) & mask
    w[..., 0] = (w[..., 0] & ~mask) | v


def get_channel(frames: np.ndarray) -> np.ndarray:
    lsb, width = TDE_HEADER_FIELDS["channel"]
    w2 = _words64(frames)[..., 2]
    return ((w2 >> np.uint64(lsb)) & np.uint64((1 << width) - 1)).astype(np.int64)


def set_channel(frames: np.ndarray, channel) -> None:
    lsb, width = TDE_HEADER_FIELDS["channel"]
    w = _words64(frames)
    mask = np.uint64(((1 << width) - 1) << lsb)
    v = (np.asarray(channel, dtype=np.uint64) << np.uint64(lsb)) & mask
    w[..., 2] = (w[..., 2] & ~mask) | v


def get_adc_samples(frames: np.ndarray) -> np.ndarray:
    """(..., FRAME_SIZE) -> (..., TOT_ADC16_SAMPLES) uint16."""
    return frames[..., HEADER_BYTES:].view("<u2").copy()


def set_adc_samples(frames: np.ndarray, samples) -> None:
    frames[..., HEADER_BYTES:].view("<u2")[...] = \
        np.asarray(samples, dtype=np.uint16)


def set_adc_sample(frames: np.ndarray, value, index: int) -> None:
    """TDE16Frame::set_adc_sample(value, sample_no)."""
    frames[..., HEADER_BYTES:].view("<u2")[..., index] = np.uint16(value)


def fake_timestamps(frames: np.ndarray, first_timestamp: int,
                    offset: int = EXPECTED_TICK_DIFFERENCE) -> None:
    """Adapter sets only the frame's own timestamp (hpp:48-51)."""
    set_timestamp(frames, first_timestamp)


def fake_geoid(frames: np.ndarray, crate_id: int, slot_id: int,
               link_id: int) -> None:
    set_daq_header_field(frames, "crate_id", crate_id)
    set_daq_header_field(frames, "slot_id", slot_id)


def sort_key(frames: np.ndarray):
    """Adapter operator<: order by (timestamp, channel) (hpp:27-36)."""
    return np.lexsort((get_channel(frames), get_timestamp(frames)))
