"""The TPG kernel wrapper — counterpart of ``fdreadoutlibs_tpu/ops/pallas_tpg.py``.

``process_window`` runs the SWTPG tick over a window of samples for every
channel, carrying per-channel state, and emits hit records into per-chunk
K-slot buffers — the contract of ``pallas_tpg.process_window_pallas``:

* a close writes the record [charge<<16 | tover, peak<<16 | ptime, end+1]
  (``end`` = the tick within the window; the peak word is absent for FIR
  without peak tracking, :func:`record_words`) into slot ``nclose[c]`` of
  its tc-tick chunk while ``nclose < K``; ``nclose`` counts every close, so
  closes beyond K per channel per chunk are dropped and visible;
* an empty slot is a zero end word.

Three input encodings: time2 words (``time_packed=True``, tick 2j in the
low and 2j+1 in the high 16 bits), one sample per row
(``time_packed=False``), and packed 14-bit WIBEth words (``packed14=``
``"frames"`` for the (L, T, 28) frame words, ``"words14"`` for the host's
(T, WR, 7, 128) words14 relayout; :data:`PACKED14`).  On CUDA tensors it
launches the hand-written Hopper kernels (``csrc/tpg*.cu``, ROADMAP.md's
names): K1 = time2 datapath, K2 = plain datapath, K3 = the FIR family on
any, K4 = the in-kernel 14-bit unpack (K1-K4 a warp-specialised pipeline
per 32 channels: a loader-and-front warp, then for FIR a filter-and-hit
warp, for AbsRS and StandardRS a running-sum warp and a hit warp, for
SimpleThreshold a hit warp); K5 = the two-pass FIR schedule, selected by
``fir_twopass`` 1 or 2 as ``pallas_tpg.process_window_pallas`` selects
``_fir2_kernel`` (the same pipeline with a warp each for front, filter
and hit; its slabs live in shared memory, so it takes no scratch); and the
variants of
``_tpg_kernel`` that its arguments select: K2b = an int16 state
(``pack_state(dtype=torch.int16)``, the native int16 arithmetic of
``fixedpoint.I16Fx`` on an int16 feed; the same pipeline, its roles on the
int16 arithmetic), K3b
= ``fir_packed`` (the FIR family with the SWAR carry: K3's pipeline, its
front warp carrying the IQR rows and its hit warp the hit word packed in
16-bit halves), K4b-gather =
``words14_gather`` and K4b-slab = ``words14_slab`` (the words14 unpack as a
gather, or into a slab of time2 words before the time2 tick; both the same
pipeline, the slab unpacked a stage of the ring at a time).  With
:data:`SLOT_WORD_CARRY` set, the fused kernels keep a chunk's records in
registers and shared memory and store them at the chunk's end (the emission
layout ``pallas_tpg.SLOT_WORD_CARRY``; same outputs).  On CPU
tensors it runs the kernel's plain version: :func:`process_window_plain`,
which loops over ticks calling ``ops/step.py::dispatch_tick`` through the
torch namespace (``ops/xp.py``), or :func:`process_window_twopass_plain`
for K5, after the torch unpack for packed words.  There is no other route:
a CUDA tensor that the kernel cannot take raises.

The port's layouts drop the TPU tile blocking: state is (KSTATE, C) int32
(or int16) on the device (the FIR ring in rows ``_FIR_ROW0..+8``, oldest-first),
slots (T/tc, K, nw, C), nclose (T/tc, C), for every encoding (the
words14 lane positions of the JAX fused kernels are a TPU tile rule).
:func:`state_from_jax` / :func:`state_to_jax` convert state to and from the
JAX package's blocked ``pack_state`` stack, canonical or in words14
positions, so both packages can start from one state.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats import wibeth
from ..utils.tuning import SHIPPED_GEOMETRY, Geometry, geometry_problem
from . import _build
from .chanstate import FIELDS, NSTATE
from .config import Algorithm, TPGConfig
from .fir import (default_taps, fir_filter, fir_hit_update, fir_iqr_update,
                  fir_pedestal_sub, fir_threshold, fir_to_add)
from .fixedpoint import wrap_i16
from .step import dispatch_tick
from .xp import DTYPES, TorchXP, check_supported, make_fx

# Emission record layout of the fused kernels (K1-K4 and their variants),
# read at each launch — counterpart of ``pallas_tpg.SLOT_WORD_CARRY`` (:67),
# which is read at trace time.  False: a close stores its record straight
# into its slot in global memory.  True: the chunk's K x nw record words
# ride in registers (the first ``_CARRY_SLOTS`` slots, written by a chain
# of predicated selects) and in shared memory (the slots above) and are
# stored once, where the chunk stores nclose (``csrc/tpg.cuh::CarrySlots``).
# The outputs are the same bit for bit, so the plain version does not read
# it; K5 has the direct store only, as ``_fir2_kernel``.  No entry sets it:
# ``probes/slots_ab.py`` and the tests flip and restore it.
SLOT_WORD_CARRY = False
# csrc/tpg.cuh::kCarrySlots, the slots a thread carries in registers (for
# the refusal's message; the bytes are the C entry's, carry_shared_bytes)
_CARRY_SLOTS = 4

N_FIR_TAPS = 8
KSTATE = NSTATE + 1 + N_FIR_TAPS           # + rs_memory_factor + FIR ring rows
_STATE_KEYS = FIELDS + ("rs_memory_factor",)
_FIR_ROW0 = NSTATE + 1                     # first FIR ring row in the stack

# state fields carried through the tick loop, per algorithm family
_LIVE_SIMPLE = ("pedestals", "accum", "prev_was_over", "hit_charge",
                "hit_tover", "hit_peak_adc", "hit_peak_time")
# RS derives prev_was_over from the carried rs value (step.py)
_LIVE_RS = tuple(k for k in _LIVE_SIMPLE if k != "prev_was_over") + \
    ("rs", "pedestals_rs", "accum_rs", "rs_memory_factor")
_LIVE_FIR = _LIVE_SIMPLE + ("quantile25", "quantile75", "accum25", "accum75")

# the TPU layout the state converter reads and writes
_LANES = 128
_SUBLANES = 8

# csrc/tpg.cuh family and encoding codes (_PLAIN16: plain samples on the
# int16 state)
_FAMILY = {Algorithm.SIMPLE_THRESHOLD: 0, Algorithm.ABS_RS: 1,
           Algorithm.STANDARD_RS: 2, Algorithm.FIR: 3}
_PLAIN, _TIME2, _PACKED14, _GATHER14, _SLAB14, _PLAIN16 = 0, 1, 2, 3, 4, 5
# the fir_packed carry's bias (fir.tpg_tick_fir)
_B = 1 << 15

# packed 14-bit feed layouts (``packed14=``): the (L, T, 28) frame words of
# L links, and the (T, WR, 7, 128) words14 rows of native.relayout_words14
PACKED14 = ("frames", "words14")


def record_words(cfg: TPGConfig) -> int:
    """int32 words per hit record: [charge<<16|tover, peak<<16|ptime,
    end_tick+1], with the peak word dropped for kernels that do not track
    peaks (reference-shaped FIR records)."""
    return 2 if (cfg.algorithm == Algorithm.FIR
                 and not cfg.track_peaks) else 3


def live_fields(cfg: TPGConfig):
    if cfg.algorithm == Algorithm.SIMPLE_THRESHOLD:
        return _LIVE_SIMPLE
    if cfg.algorithm == Algorithm.FIR:
        if not cfg.track_peaks:
            return tuple(k for k in _LIVE_FIR
                         if k not in ("hit_peak_adc", "hit_peak_time"))
        return _LIVE_FIR
    return _LIVE_RS


def auto_tc(T: int, cap: int = 512) -> int:
    """Largest divisor of T not exceeding the chunk cap."""
    for tc in range(min(T, cap), 0, -1):
        if T % tc == 0:
            return tc
    return T


# ---- state layout ---------------------------------------------------------

def pack_state(state: dict, n_channels: int, device="cpu",
               dtype=torch.int32) -> torch.Tensor:
    """ChanState dict of (C,) arrays -> (KSTATE, C) tensor.  dtype=
    torch.int16 selects the native int16 state mode (K2b; pack the samples
    as int16 too), values cast as ``pallas_tpg.pack_state`` casts them."""
    if dtype not in DTYPES:
        raise ValueError(f"state dtype must be int32 or int16, not {dtype}")
    np_dtype = np.int16 if dtype == torch.int16 else np.int32
    out = np.zeros((KSTATE, n_channels), dtype=np_dtype)
    for i, k in enumerate(_STATE_KEYS):
        out[i] = np.broadcast_to(np.asarray(state[k]).astype(np_dtype),
                                 (n_channels,))
    fir = state.get("fir_prev")
    if fir is not None:
        out[_FIR_ROW0:_FIR_ROW0 + N_FIR_TAPS] = np.asarray(fir).astype(
            np_dtype)
    return torch.from_numpy(out).to(device)


def unpack_state(state: torch.Tensor) -> dict:
    """(KSTATE, C) tensor -> ChanState-style dict of (C,) int32 numpy
    arrays."""
    arr = state.cpu().numpy().astype(np.int32)
    st = {k: arr[i].copy() for i, k in enumerate(_STATE_KEYS)}
    st["fir_prev"] = arr[_FIR_ROW0:_FIR_ROW0 + N_FIR_TAPS].copy()
    return st


def _jax_rows(n_lanes: int, granule: int) -> int:
    """Sublane rows of a JAX ``pack_state`` stack covering n_lanes lanes."""
    rows = -(-n_lanes // _LANES)
    return -(-rows // granule) * granule


def _jax_lanes(n_channels: int, positions, granule: int) -> int:
    """Flat lanes of the JAX stack: canonical, or the words14 positions
    (``pallas_tpg.pack_state`` :167-171)."""
    n = n_channels if positions is None else int(np.max(positions)) + 1
    return _jax_rows(n, granule) * _LANES


def state_from_jax(stack_np, n_channels: int, device="cpu",
                   positions=None) -> torch.Tensor:
    """JAX ``pack_state`` stack (NB, KSTATE, SUB, 128), as numpy -> the
    port's (KSTATE, C) tensor in canonical channel order, int16 for an
    int16 stack and int32 otherwise.  ``positions`` is the channel ->
    flat-lane map the stack was packed with (the fused words14 kernels'
    ``words14_positions``); without it the stack must have the canonical
    row count, else this raises."""
    arr = np.asarray(stack_np)
    int16 = arr.dtype.itemsize == 2
    granule = 16 if int16 else _SUBLANES
    arr = arr.astype(np.int16 if int16 else np.int32)
    nb, kst, sub, lanes = arr.shape
    if kst != KSTATE or lanes != _LANES:
        raise ValueError(f"not a JAX state stack: shape {arr.shape}")
    want = _jax_lanes(n_channels, positions, granule)
    if nb * sub * lanes != want:
        raise ValueError(
            f"a state stack of {nb * sub} rows does not hold {n_channels} "
            + ("channels in canonical order; pass the positions it was "
               "packed with" if positions is None else
               "channels at the given positions")
            + f" (expected {want // _LANES} rows)")
    flat = arr.transpose(1, 0, 2, 3).reshape(KSTATE, want)
    sel = slice(None, n_channels) if positions is None \
        else np.asarray(positions)
    return torch.from_numpy(np.ascontiguousarray(flat[:, sel])).to(device)


def state_to_jax(state: torch.Tensor, block_sublanes: int | None = None,
                 positions=None) -> np.ndarray:
    """The port's (KSTATE, C) tensor -> the JAX ``pack_state`` stack
    (NB, KSTATE, SUB, 128) numpy array of the state's dtype, zero-padded to
    whole sublane tiles like ``pack_state`` (8 rows for int32, 16 for
    int16); ``positions`` places channel c at flat lane positions[c] (the
    words14 layout)."""
    C = state.shape[1]
    int16 = state.dtype == torch.int16
    n = _jax_lanes(C, positions, 16 if int16 else _SUBLANES)
    S = n // _LANES
    sub = block_sublanes or S
    if S % sub:
        raise ValueError(f"block_sublanes={sub} does not tile {S} rows")
    flat = np.zeros((KSTATE, n), dtype=np.int16 if int16 else np.int32)
    sel = slice(None, C) if positions is None else np.asarray(positions)
    flat[:, sel] = state.cpu().numpy()
    return flat.reshape(KSTATE, S // sub, sub, _LANES).transpose(1, 0, 2, 3) \
        .copy()


# ---- the plain version ----------------------------------------------------

def _check_packed(feed, C: int, packed14: str) -> int:
    """Shape checks of a packed 14-bit feed; returns its tick count."""
    if packed14 not in PACKED14:
        raise ValueError(f"packed14={packed14!r}: expected one of "
                         f"{PACKED14}")
    if feed.dtype != torch.int32:
        raise ValueError("packed words must be int32 (a .view of uint32)")
    if C % 16:
        raise ValueError(f"{C} channels is not a whole number of 16-channel "
                         "word groups")
    if packed14 == "frames":
        if feed.dim() != 3 or feed.shape[2] != 2 * wibeth.ADC_WORDS_PER_TS:
            raise ValueError(f"expected frame words (L, T, 28), got "
                             f"{tuple(feed.shape)}")
        groups, T = 4 * feed.shape[0], feed.shape[1]
    else:
        if feed.dim() != 4 or tuple(feed.shape[2:]) != (7, _LANES):
            raise ValueError(f"expected words14 rows (T, WR, 7, 128), got "
                             f"{tuple(feed.shape)}")
        groups, T = feed.shape[1] * _LANES, feed.shape[0]
    if groups < C // 16:
        raise ValueError(f"the packed feed holds {16 * groups} channels < "
                         f"{C}")
    return T


def _check_window(feed, state, tc: int, k_slots: int, time_packed: bool,
                  packed14: str | None = None):
    if state.dim() != 2 or state.shape[0] != KSTATE:
        raise ValueError(f"expected state ({KSTATE}, C), got "
                         f"{tuple(state.shape)}")
    if state.dtype not in DTYPES:
        raise ValueError("state must be int32 or int16")
    int16 = state.dtype == torch.int16
    if int16 and (time_packed or packed14 is not None):
        # pallas_tpg.py:830, :846-849: the int16 mode has the plain
        # datapath only
        raise ValueError("an int16 state runs the plain datapath only "
                         "(time_packed=False, no packed14)")
    C = state.shape[1]
    if packed14 is not None:
        if time_packed:
            raise ValueError("packed14 and time_packed are exclusive "
                             "encodings")
        T = _check_packed(feed, C, packed14)
    else:
        if feed.dim() != 2:
            raise ValueError(f"expected feed (rows, W), got "
                             f"{tuple(feed.shape)}")
        if feed.dtype != state.dtype:
            # pallas_tpg.py:850-852
            raise ValueError(f"feed must be {state.dtype} like the state "
                             "(pack the samples and the state with one "
                             "dtype)")
        if feed.shape[1] < C:
            raise ValueError(f"feed rows hold {feed.shape[1]} lanes < {C} "
                             "channels")
        T = feed.shape[0] * (2 if time_packed else 1)
    if tc <= 0 or T % tc or (time_packed and tc % 2):
        raise ValueError(f"tc={tc} must divide T={T}"
                         + (" and be even (two ticks per word)"
                            if time_packed else ""))
    if k_slots < 1:
        raise ValueError("k_slots must be >= 1")
    return T, C


def unpack_packed14(feed: torch.Tensor, packed14: str,
                    n_channels: int) -> torch.Tensor:
    """The torch unpack of a packed 14-bit feed -> (T, C) int32 samples in
    canonical channel order: what K4 extracts in-register."""
    if packed14 == "frames":
        adcs = wibeth.unpack_frames(feed.transpose(0, 1))   # (T, L, 64)
        return adcs.reshape(adcs.shape[0], -1)[:, :n_channels]
    return wibeth.unpack_words14(feed, n_channels)


def _options(cfg: TPGConfig, state: torch.Tensor, tc: int,
             packed14: str | None, fir_twopass: int, fir_packed,
             words14_gather: bool, words14_slab: bool):
    """The JAX argument rules of ``process_window_pallas`` (:829-876):
    raise where it raises, drop what it ignores.  Returns the effective
    (fir_packed, words14_gather, words14_slab)."""
    _check_twopass(cfg, fir_twopass)
    int16 = state.dtype == torch.int16
    if fir_twopass and int16:
        raise ValueError("fir_twopass requires the FIR family with int32 "
                         "state")
    # fir_packed=None is off; silently off but for FIR on an int32 state
    fir_packed = bool(fir_packed) and cfg.algorithm == Algorithm.FIR \
        and not int16
    if fir_twopass and fir_packed:
        raise ValueError("fir_twopass and fir_packed are exclusive (the "
                         "packed SWAR carry is fused-tick-only)")
    if packed14 == "frames" and (words14_gather or words14_slab):
        raise ValueError("words14_gather and words14_slab take words14 rows "
                         "(packed14='words14'), not frame words")
    if words14_slab:
        if packed14 != "words14":
            raise ValueError("words14_slab requires words14 input")
        if tc % 16:
            raise ValueError(f"words14_slab needs tc % 16 == 0, got tc={tc}")
        if fir_twopass:
            raise ValueError("fir_twopass and words14_slab are exclusive "
                             "(the slab unpack is fused-tick-only)")
    return fir_packed, bool(words14_gather) and packed14 == "words14", \
        bool(words14_slab)


def _samples(feed: torch.Tensor, C: int, time_packed: bool,
             packed14: str | None, words14_gather: bool = False,
             words14_slab: bool = False) -> torch.Tensor:
    """The feed as (T, C) samples: the torch unpack of packed words (the
    gather formulation with ``words14_gather``; with ``words14_slab`` the
    unpacked samples paired into time2 words as the slab holds them, and
    split again), the time2 words split into their two ticks, or the
    rows."""
    if packed14 is not None:
        if words14_slab:
            x = unpack_packed14(feed, packed14, C)
            return _samples((x[0::2] & 0xFFFF) | (x[1::2] << 16), C, True,
                            None)
        if words14_gather:
            return wibeth.unpack_words14_gather(feed, C)
        return unpack_packed14(feed, packed14, C)
    x = feed[:, :C]
    if time_packed:
        return torch.stack([wrap_i16(x), x >> 16], dim=1).reshape(-1, C)
    return x


def _emit(slots_c, nclose_c, closed, rec, end_word: int, k_slots: int,
          nw: int) -> None:
    """Masked stores of one tick's closes into a chunk's slots
    ((K + 1, nw, C); slot K is a sink for closes beyond capacity, dropped
    but counted in ``nclose_c``)."""
    C = closed.shape[0]

    def pair(hi, lo):
        return (hi.to(torch.int32) << 16) | lo.to(torch.int32)
    # the fir_packed carry already holds the first word
    words = [rec["w0"] if "w0" in rec else pair(rec["charge"], rec["tover"])]
    if nw == 3:
        words.append(pair(rec["peak_adc"], rec["peak_time"]))
    words.append(torch.full((C,), end_word, dtype=torch.int32,
                            device=closed.device))
    slot = torch.where(closed, torch.clamp(nclose_c, max=k_slots),
                       k_slots).long()
    slots_c.scatter_(0, slot.expand(nw, C)[None], torch.stack(words)[None])
    nclose_c += closed.to(torch.int32)


_PACKED_ROWS = ("quantile25", "quantile75", "accum25", "accum75",
                "hit_charge", "hit_tover", "prev_was_over")


def _pack_swar(row) -> dict:
    """The fir_packed carry from the canonical state rows
    (``pallas_tpg._tpg_kernel`` :491-501)."""
    return {"iqr_qpair": ((row("quantile25") + _B) & 0xFFFF)
            | ((row("quantile75") + _B) << 16),
            "iqr_apair": ((row("accum25") + _B) & 0xFFFF)
            | ((row("accum75") + _B) << 16),
            "hit_ct": (row("hit_charge") << 16) | (row("hit_tover") & 0x7FFF)
            | ((row("prev_was_over") != 0).to(torch.int32) << 15)}


def _unpack_swar(st: dict) -> dict:
    """The canonical state rows from the fir_packed carry (:561-574)."""
    qp, ap, ct = st["iqr_qpair"], st["iqr_apair"], st["hit_ct"]
    return {"quantile25": (qp & 0xFFFF) - _B,
            "quantile75": ((qp >> 16) & 0xFFFF) - _B,
            "accum25": (ap & 0xFFFF) - _B,
            "accum75": ((ap >> 16) & 0xFFFF) - _B,
            "hit_charge": ct >> 16, "hit_tover": ct & 0x7FFF,
            "prev_was_over": (ct >> 15) & 1}


def process_window_plain(feed: torch.Tensor, state: torch.Tensor,
                         cfg: TPGConfig, tc: int, k_slots: int,
                         time_packed: bool = True,
                         packed14: str | None = None, fir_packed=None,
                         words14_gather: bool = False,
                         words14_slab: bool = False):
    """The plain PyTorch version of K1-K4 and their variants: a loop over
    ticks calling ``ops/step.py::dispatch_tick`` on (C,) tensors of the
    state's dtype (int16: ``fixedpoint.I16Fx``, K2b), with the slot writes
    as masked stores.  The FIR ring rides the tick as a tuple of the 8
    state rows, oldest-first (the Pallas kernel's carry); with
    ``fir_packed`` (K3b) the IQR rows and the hit word ride as the SWAR
    carry, packed from the state rows before the loop and unpacked after
    it.  A packed 14-bit feed is unpacked first (:func:`_samples`).  Runs
    on any device; returns fresh tensors."""
    check_supported(cfg, state)
    T, C = _check_window(feed, state, tc, k_slots, time_packed, packed14)
    fir_packed, words14_gather, words14_slab = _options(
        cfg, state, tc, packed14, 0, fir_packed, words14_gather,
        words14_slab)
    x = _samples(feed, C, time_packed, packed14, words14_gather,
                 words14_slab)
    dev = state.device
    xp = TorchXP(dev, state.dtype)
    fx = make_fx(xp)
    keys = live_fields(cfg)
    if fir_packed:
        keys = tuple(k for k in keys if k not in _PACKED_ROWS)
    st = {k: state[_STATE_KEYS.index(k)] for k in keys}
    is_fir = cfg.algorithm == Algorithm.FIR
    if is_fir:
        st["fir_prev"] = tuple(state[_FIR_ROW0 + j]
                               for j in range(N_FIR_TAPS))
    if fir_packed:
        st.update(_pack_swar(lambda k: state[_STATE_KEYS.index(k)]))
    nw = record_words(cfg)
    n_chunks = T // tc
    slots = torch.zeros((n_chunks, k_slots + 1, nw, C), dtype=torch.int32,
                        device=dev)
    nclose = torch.zeros((n_chunks, C), dtype=torch.int32, device=dev)
    for t in range(T):
        st, closed, rec = dispatch_tick(st, x[t], cfg, xp, fx=fx)
        _emit(slots[t // tc], nclose[t // tc], closed, rec, t + 1, k_slots,
              nw)
    new_state = state.clone()
    rows = {k: st[k] for k in keys}
    if fir_packed:
        rows.update(_unpack_swar(st))
    for k, row in rows.items():
        new_state[_STATE_KEYS.index(k)] = row
    if is_fir:
        for j, row in enumerate(st["fir_prev"]):
            new_state[_FIR_ROW0 + j] = row
    return slots[:, :k_slots].contiguous(), nclose, new_state


def _check_twopass(cfg: TPGConfig, fir_twopass: int) -> None:
    if fir_twopass not in (0, 1, 2):
        raise ValueError(f"fir_twopass={fir_twopass!r}: expected 0, 1 or 2")
    if fir_twopass and cfg.algorithm != Algorithm.FIR:
        raise ValueError("fir_twopass requires the FIR family")


# the pass-A state rows
_FIR_FRONT = ("pedestals", "accum", "quantile25", "accum25", "quantile75",
              "accum75")


def process_window_twopass_plain(feed: torch.Tensor, state: torch.Tensor,
                                 cfg: TPGConfig, tc: int, k_slots: int,
                                 fir_twopass: int, time_packed: bool = True,
                                 packed14: str | None = None,
                                 words14_gather: bool = False,
                                 fir_packed=None, words14_slab: bool = False):
    """The plain PyTorch version of K5 (``pallas_tpg._fir2_kernel``,
    fir_twopass 1 or 2): per tc-tick chunk, on (tc, C) tensors,

    * pass A, a loop over ticks of ``fir_iqr_update`` + ``fir_pedestal_sub``
      writing the s slab (the 8 carried ring rows, oldest first, then the
      chunk's clamped samples) and the sigma slab; the carried ring is s
      rows tc..tc+7;
    * pass B, ``fir_filter`` on 8 shifted views of the s slab,
      ``fir_threshold`` and ``fir_to_add`` on whole slabs; with lift
      (fir_twopass=2) the closed slab, is_over shifted one tick with the
      carried prev_was_over in front, and prev_was_over = is_over[tc-1];
    * pass C, a loop over ticks of ``fir_hit_update``: without lift it
      tests the close and emits into the slots as the fused tick does; with
      lift it takes the closed slab and keeps each tick's record words;
    * pass D (lift), an exclusive cumulative count of closes along time,
      and slot k the sum of the record words where closed & (count == k).

    Same outputs as :func:`process_window_plain` on a FIR config, bit for
    bit.  Takes every encoding the fused version takes (the words14 rows
    also through the gather formulation, ``words14_gather``); ``fir_packed``
    and ``words14_slab`` raise, as with ``process_window``."""
    check_supported(cfg, state)
    if not fir_twopass:
        _check_twopass(cfg, fir_twopass)
        raise ValueError("fir_twopass=0 is the fused tick: "
                         "process_window_plain")
    T, C = _check_window(feed, state, tc, k_slots, time_packed, packed14)
    _, words14_gather, _ = _options(cfg, state, tc, packed14, fir_twopass,
                                    fir_packed, words14_gather, words14_slab)
    x = _samples(feed, C, time_packed, packed14, words14_gather)
    dev = state.device
    xp = TorchXP(dev)
    fx = make_fx(xp)
    taps = cfg.taps or default_taps(cfg)
    lift = fir_twopass == 2
    row = {k: _STATE_KEYS.index(k) for k in _STATE_KEYS}
    hit_keys = tuple(k for k in live_fields(cfg) if k.startswith("hit_")
                     or (k == "prev_was_over" and not lift))
    nw = record_words(cfg)
    n_chunks = T // tc
    slots = torch.zeros((n_chunks, k_slots + 1, nw, C), dtype=torch.int32,
                        device=dev)
    nclose = torch.zeros((n_chunks, C), dtype=torch.int32, device=dev)
    new_state = state.clone()
    ring = slice(_FIR_ROW0, _FIR_ROW0 + N_FIR_TAPS)
    for chunk in range(n_chunks):
        t0 = chunk * tc
        # ---- pass A
        s_slab = torch.empty((tc + N_FIR_TAPS, C), dtype=torch.int32,
                             device=dev)
        s_slab[:N_FIR_TAPS] = new_state[ring]
        sigma = torch.empty((tc, C), dtype=torch.int32, device=dev)
        st = {k: new_state[row[k]] for k in _FIR_FRONT}
        for t in range(tc):
            upd, sigma[t] = fir_iqr_update(st, x[t0 + t], cfg, xp, fx)
            updp, s_slab[N_FIR_TAPS + t] = fir_pedestal_sub(
                st, x[t0 + t], cfg, xp, fx)
            st.update(upd)
            st.update(updp)
        for k in _FIR_FRONT:
            new_state[row[k]] = st[k]
        new_state[ring] = s_slab[tc:]
        # ---- pass B
        filt = fir_filter(tuple(s_slab[j:j + tc] for j in range(N_FIR_TAPS)),
                          taps, fx)
        is_over = fir_threshold(filt, sigma, cfg, fx)
        to_add = fir_to_add(filt, is_over, cfg, xp, fx)
        if lift:
            over = is_over.to(torch.int32)
            prev = torch.cat([new_state[row["prev_was_over"]][None],
                              over[:-1]])
            closed_slab = (prev != 0) & ~is_over
            new_state[row["prev_was_over"]] = over[tc - 1]
            rec_words = torch.empty((nw - 1, tc, C), dtype=torch.int32,
                                    device=dev)
        # ---- pass C
        st = {k: new_state[row[k]] for k in hit_keys}
        for t in range(tc):
            upd, closed, rec = fir_hit_update(
                st, is_over[t], to_add[t],
                filt[t] if cfg.track_peaks else None, cfg, xp, fx,
                closed=closed_slab[t] if lift else None)
            st.update(upd)
            if lift:
                rec_words[0, t] = (rec["charge"] << 16) | rec["tover"]
                if nw == 3:
                    rec_words[1, t] = (rec["peak_adc"] << 16) | \
                        rec["peak_time"]
            else:
                _emit(slots[chunk], nclose[chunk], closed, rec, t0 + t + 1,
                      k_slots, nw)
        for k in hit_keys:
            new_state[row[k]] = st[k]
        if not lift:
            continue
        # ---- pass D
        n = closed_slab.to(torch.int32)
        inclusive = torch.cumsum(n, dim=0, dtype=torch.int32)
        ordinal = inclusive - n                 # closes before tick t
        nclose[chunk] = inclusive[tc - 1]
        end = torch.arange(t0 + 1, t0 + tc + 1, dtype=torch.int32,
                           device=dev)[:, None].expand(tc, C)
        for k in range(k_slots):
            sel = closed_slab & (ordinal == k)
            for w, words in enumerate(list(rec_words) + [end]):
                slots[chunk, k, w] = torch.where(sel, words, 0).sum(
                    dim=0, dtype=torch.int32)
    return slots[:, :k_slots].contiguous(), nclose, new_state


# ---- the kernel -----------------------------------------------------------

_INT32 = (-(1 << 31), (1 << 31) - 1)


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K2b", "K3b", "K4b-slab",
           "K4b-gather")


def kernels_of(cfg: TPGConfig, time_packed: bool,
               packed14: str | None = None, fir_twopass: int = 0, *,
               int16: bool = False, fir_packed: bool = False,
               words14_gather: bool = False,
               words14_slab: bool = False) -> tuple:
    """ROADMAP.md's kernels that one launch runs (the effective options of
    :func:`_options`): K1 (time2 datapath, threshold/RS families), K2
    (plain-sample datapath), K4 (in-kernel 14-bit unpack; K4b-gather or
    K4b-slab for its schedules), K3 (FIR family, on any datapath; K3b with
    the SWAR carry, whose code then runs the whole launch: :func:`kernel_of`),
    K2b alone for an int16 state (every family) — or K5 alone, the two-pass
    FIR schedule (its own C entry, on any datapath).  The names stay
    ROADMAP.md's whatever code runs them: each is a mode of the pipeline of
    ``csrc/tpg.cuh``."""
    if fir_twopass:
        return ("K5",)
    if int16:
        return ("K2b",)
    is_fir = cfg.algorithm == Algorithm.FIR
    if packed14 is not None:
        datapath = ("K4b-slab",) if words14_slab else \
            ("K4b-gather",) if words14_gather else ("K4",)
    elif time_packed:
        datapath = () if is_fir else ("K1",)
    else:
        datapath = ("K2",)
    family = (("K3b",) if fir_packed else ("K3",)) if is_fir else ()
    return datapath + family


def kernel_of(cfg: TPGConfig, time_packed: bool,
              packed14: str | None = None, fir_twopass: int = 0, *,
              int16: bool = False, fir_packed: bool = False,
              words14_gather: bool = False,
              words14_slab: bool = False) -> str:
    """The one kernel of ROADMAP.md whose code a launch runs (the effective
    options of :func:`_options`), where :func:`kernels_of` names every
    kernel on its datapath: K5, K2b, K3b whenever ``fir_packed`` is in
    effect (on any feed: K3's mode of the pipeline with the packed front
    and back), K4b-slab or K4b-gather, K4 for any family on packed words,
    K3 for the FIR fused tick on plain and time2 rows, else K1 (time2) or
    K2 (plain samples) for the threshold families (each a mode of the
    pipeline of ``csrc/tpg.cuh``; K4b-slab and K4b-gather its modes on
    words14 rows)."""
    if fir_twopass:
        return "K5"
    if int16:
        return "K2b"
    if fir_packed:
        return "K3b"
    if packed14 is not None:
        return "K4b-slab" if words14_slab else \
            "K4b-gather" if words14_gather else "K4"
    if cfg.algorithm == Algorithm.FIR:
        return "K3"
    return "K1" if time_packed else "K2"


def reset_launches() -> None:
    """Zero the launch counts: total, per kernel on its datapath with the
    direct store (:func:`kernels_of`), per kernel with the carry layout
    (:data:`SLOT_WORD_CARRY`), and per kernel function whatever the layout
    (:func:`kernel_of`)."""
    process_window.launches = 0
    process_window.kernel_launches = {k: 0 for k in KERNELS}
    process_window.carry_launches = {k: 0 for k in KERNELS}
    process_window.function_launches = {k: 0 for k in KERNELS}


def geometry_defines(geometry: Geometry | None = None) -> tuple:
    """The ``csrc/tpg.cuh`` defines of a pipeline geometry
    (``utils.tuning.Geometry``): one (name, value) pair for each field
    that differs from the shipped geometry, so the shipped one (or None)
    builds with no define, under the library's usual key."""
    g = SHIPPED_GEOMETRY if geometry is None else Geometry(*geometry)
    return tuple((name, v) for name, v, s in zip(
        ("TPG_GROUP", "TPG_PIPE_TICKS", "TPG_PIPE_STAGES"), g,
        SHIPPED_GEOMETRY) if v != s)


def library(geometry: Geometry | None = None):
    """The tpg kernel library of ``geometry`` (None: the shipped one),
    built at first use (needs nvcc)."""
    return _build.load("tpg", geometry_defines(geometry))


def _check_geometry(geometry, cfg: TPGConfig, tc: int, fir_twopass: int,
                    words14_slab: bool) -> None:
    """The rules a geometry's build and launch hold it to
    (``utils.tuning.geometry_problem``: ``csrc/tpg.cuh``'s static_asserts
    and the ring's shared memory, for every encoding of the family), and
    the slab unpack's chunk of whole groups (``make_params``)."""
    if geometry is None:
        return
    g = Geometry(*geometry)
    why = geometry_problem(g, cfg.algorithm, None, cfg.track_peaks,
                           fir_twopass)
    if why is not None:
        raise ValueError(f"geometry {tuple(g)}: {why}")
    if words14_slab and tc % g.group:
        raise ValueError(f"words14_slab unpacks whole groups: tc={tc} is "
                         f"not a multiple of group={g.group}")


def carry_shared_bytes(cfg: TPGConfig, tc: int, k_slots: int,
                       encoding: int = _PLAIN, lib=None) -> tuple:
    """(bytes, most): the shared memory one block of a fused launch takes
    under :data:`SLOT_WORD_CARRY`, and the most a block may take, from the
    C entry ``csrc/tpg.cu::tpg_shared_bytes`` of ``lib`` (the card's tpg
    library by default) for these arguments: the launch's own count
    (``csrc/tpg.cuh::fused_shared_bytes``: the pipeline's ring of
    ``pipe_slabs`` slabs per stage, K4b-slab's time2 slab among them; the
    staging of the slots above the register ceiling in columns of 32
    channels, no more than a chunk of tc ticks can close, ceil(tc / 2) per
    channel; its mbarriers).  ``encoding`` is the launch's csrc/tpg.cuh
    code (``_PLAIN16`` for int16 samples).  A geometry's own library
    (:func:`library`) counts its own ring."""
    fn = (library() if lib is None else lib).tpg_shared_bytes
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    most = ctypes.c_int(0)
    need = fn(tc, k_slots, encoding, _FAMILY[cfg.algorithm],
              int(cfg.track_peaks), 1, ctypes.byref(most))
    return int(need), most.value


# csrc/tpg.cu::tpg_launch's C signature (the staged arms' too), and
# tpg_fir2_launch's: the same with lift before (device, stream)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 8
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_int] * 9
             + [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p])
_FIR2_ARGTYPES = _ARGTYPES[:-2] + [ctypes.c_int] + _ARGTYPES[-2:]


def _kernel_fn(fir_twopass: int = 0, lib=None):
    lib = library() if lib is None else lib
    fn = lib.tpg_fir2_launch if fir_twopass else lib.tpg_launch
    fn.argtypes = _FIR2_ARGTYPES if fir_twopass else _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _feed_layout(feed: torch.Tensor, time_packed: bool,
                 packed14: str | None, words14_gather: bool = False,
                 words14_slab: bool = False):
    """(feed_stride, encoding, groups_per_row, group_outer, group_inner,
    word_stride) of ``csrc/tpg.cu::tpg_launch`` for a contiguous feed."""
    if packed14 == "frames":                 # (L, T, 28)
        T, W = feed.shape[1], feed.shape[2]
        return W, _PACKED14, 4, T * W, 7, 1
    if packed14 == "words14":                # (T, WR, 7, 128)
        WR = feed.shape[1]
        enc = _SLAB14 if words14_slab else \
            _GATHER14 if words14_gather else _PACKED14
        return WR * 7 * _LANES, enc, _LANES, 7 * _LANES, 1, _LANES
    return feed.shape[1], _TIME2 if time_packed else _PLAIN, 0, 0, 0, 0


def _fir_args(cfg: TPGConfig):
    """(taps as a C int[8], tap_exponent, adc_max, sigma_cap, thr_mult) of
    ``ops/fir.py`` for the kernel; zeros for the other families."""
    taps = (0,) * N_FIR_TAPS
    sigma_cap = thr_mult = 0
    if cfg.algorithm == Algorithm.FIR:
        taps = tuple(int(t) for t in (cfg.taps or default_taps(cfg)))
        if len(taps) > N_FIR_TAPS:
            raise ValueError(f"{len(taps)} FIR taps; the filter holds "
                             f"{N_FIR_TAPS}")
        # trailing zero taps read nothing (fir_filter skips them)
        taps += (0,) * (N_FIR_TAPS - len(taps))
        sigma_cap = (1 << 15) // (cfg.multiplier * 5)
        thr_mult = cfg.threshold * cfg.multiplier
    for v in taps + (cfg.threshold, thr_mult):
        if not _INT32[0] <= v <= _INT32[1]:
            raise ValueError(f"{v} does not fit the kernel's int32 "
                             "arguments")
    return ((ctypes.c_int * N_FIR_TAPS)(*taps), cfg.tap_exponent,
            cfg.adc_max, sigma_cap, thr_mult)


def _launch(fn, feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
            tc: int, k_slots: int, time_packed: bool, packed14: str | None,
            device: int, stream, fir_twopass: int = 0, fir_packed=None,
            words14_gather: bool = False, words14_slab: bool = False,
            lib=None):
    """Allocate the outputs beside ``state`` and call the C entry ``fn``
    (``tpg_launch``, or ``tpg_fir2_launch`` when ``fir_twopass``) on
    contiguous, checked tensors, with the effective options of
    :func:`_options` and the emission layout :data:`SLOT_WORD_CARRY` names
    now; under that layout a launch whose block would not fit its shared
    memory (:func:`carry_shared_bytes` from ``lib``, the library of ``fn``,
    the card's by default) raises first.  Returns (slots, nclose,
    new_state)."""
    T, C = _check_window(feed, state, tc, k_slots, time_packed, packed14)
    layout = _feed_layout(feed, time_packed, packed14, words14_gather,
                          words14_slab)
    carry = bool(SLOT_WORD_CARRY) and not fir_twopass
    if carry:
        enc = _PLAIN16 if state.dtype == torch.int16 else layout[1]
        need, most = carry_shared_bytes(cfg, tc, k_slots, enc, lib)
        if need > most:
            raise ValueError(
                f"SLOT_WORD_CARRY stages min(k_slots, ceil(tc / 2)) - "
                f"{_CARRY_SLOTS} slots per thread in shared memory: "
                f"tc={tc}, k_slots={k_slots} need {need} B > {most} B a "
                "block may use")
    taps, tap_exponent, adc_max, sigma_cap, thr_mult = _fir_args(cfg)
    n_chunks = T // tc
    nw = record_words(cfg)
    slots = torch.zeros((n_chunks, k_slots, nw, C), dtype=torch.int32,
                        device=state.device)
    nclose = torch.empty((n_chunks, C), dtype=torch.int32,
                         device=state.device)
    new_state = state.clone()
    floor = cfg.algorithm != Algorithm.SIMPLE_THRESHOLD or cfg.threshold < 0
    twopass = (int(fir_twopass == 2),) if fir_twopass else ()
    err = fn(
        feed.data_ptr(), *layout, n_chunks, tc, new_state.data_ptr(), C,
        slots.data_ptr(), nclose.data_ptr(), k_slots, _FAMILY[cfg.algorithm],
        int(cfg.peak_gated), int(floor), int(cfg.track_peaks),
        int(cfg.fir_avx_semantics), cfg.threshold, cfg.accumulator_limit,
        cfg.rs_scale_factor_x10, taps, tap_exponent, adc_max, sigma_cap,
        thr_mult, int(state.dtype == torch.int16), int(bool(fir_packed)),
        int(cfg.rs_float), int(carry), *twopass, device, stream)
    if err != 0:
        raise RuntimeError(f"tpg kernel launch failed: CUDA error {err}")
    return slots, nclose, new_state


def launch_kernel(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                  tc: int, k_slots: int, time_packed: bool = True,
                  packed14: str | None = None, fir_twopass: int = 0,
                  fir_packed=None, words14_gather: bool = False,
                  words14_slab: bool = False,
                  geometry: Geometry | None = None):
    """Launch ``csrc/tpg*.cu`` on CUDA tensors (the wrapper's CUDA route):
    K1-K4 and their variants, or K5 when ``fir_twopass`` is 1 or 2, from
    the library of ``geometry`` (None: the shipped one).  ``state`` is not
    modified: the kernel updates a copy in place and returns it.  Raises on
    anything the kernel does not take."""
    check_supported(cfg, state)
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device):
        raise ValueError("the tpg kernel needs feed and state on one CUDA "
                         f"device, got {feed.device} and {state.device}")
    if not (feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("feed and state must be contiguous")
    fir_packed, words14_gather, words14_slab = _options(
        cfg, state, tc, packed14, fir_twopass, fir_packed, words14_gather,
        words14_slab)
    _check_geometry(geometry, cfg, tc, fir_twopass, words14_slab)
    dev = state.device
    lib = library(geometry)
    out = _launch(_kernel_fn(fir_twopass, lib), feed, state, cfg, tc,
                  k_slots, time_packed, packed14,
                  dev.index if dev.index is not None
                  else torch.cuda.current_device(),
                  torch.cuda.current_stream(dev).cuda_stream, fir_twopass,
                  fir_packed, words14_gather, words14_slab, lib)
    count_launch(cfg, time_packed, packed14, fir_twopass,
                 int16=state.dtype == torch.int16, fir_packed=fir_packed,
                 words14_gather=words14_gather, words14_slab=words14_slab)
    return out


def count_launch(cfg: TPGConfig, time_packed: bool, packed14: str | None,
                 fir_twopass: int, **opts) -> None:
    """Count one kernel launch (its effective options; ``opts`` as
    :func:`kernels_of` takes them) in :func:`reset_launches`'s counts."""
    process_window.launches += 1
    counts = process_window.carry_launches \
        if SLOT_WORD_CARRY and not fir_twopass \
        else process_window.kernel_launches
    for k in kernels_of(cfg, time_packed, packed14, fir_twopass, **opts):
        counts[k] += 1
    process_window.function_launches[
        kernel_of(cfg, time_packed, packed14, fir_twopass, **opts)] += 1


def process_window(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                   tc: int, k_slots: int, time_packed: bool = True,
                   packed14: str | None = None, fir_twopass: int = 0,
                   fir_packed=None, words14_gather: bool = False,
                   words14_slab: bool = False,
                   geometry: Geometry | None = None):
    """Run the TPG over one window, carrying state.

    Args:
      feed: (T/2, W) int32 time-paired words (tick 2j in the low 16 bits,
        2j+1 in the high 16 bits, channel c at column c, W >= C) — or, with
        time_packed=False, (T, W) samples of the state's dtype — or, with
        ``packed14`` (time_packed=False), packed 14-bit words as int32:
        "frames" takes (L, T, 28) frame words (channel = link*64 + c),
        "words14" the (T, WR, 7, 128) rows of ``native.relayout_words14``;
        C % 16 == 0.
      state: (KSTATE, C) int32, or int16 for the native int16 mode (K2b:
        plain datapath only, an int16 feed), from :func:`pack_state`; not
        modified.
      tc: ticks per chunk (divides T; even when time_packed).
      k_slots: per-channel hit capacity per chunk.
      fir_twopass: the FIR schedule (``utils.tuning.kernel_knobs``): 0 the
        fused tick (K3), 1 the two-pass schedule, 2 two-pass with lifted
        emission (K5); 1 and 2 raise ValueError for another family.
      fir_packed: the SWAR carry (K3b); None or False is off, and it is
        silently off unless the family is FIR and the state int32.
      words14_gather: the words14 unpack as a gather (K4b-gather; with
        fir_twopass too); words14_slab: the samples unpacked into time2
        words before the tick (K4b-slab; tc % 16 == 0, not with
        fir_twopass).  Both take packed14="words14" only; the gather is
        ignored for the unpacked encodings, as in the JAX package.
      geometry: the pipeline's compile-time shape (``utils.tuning.
        Geometry``; ``kernel_knobs(cfg)["geometry"]``), a kernel library
        of its own; None is the shipped one.  It changes no output: the
        plain version checks its rules and otherwise ignores it.

    Returns (slots (T/tc, K, nw, C), nclose (T/tc, C), new_state).
    """
    if feed.device.type == "cpu" and state.device.type == "cpu":
        _check_geometry(geometry, cfg, tc, fir_twopass,
                        bool(words14_slab) and packed14 == "words14")
        if fir_twopass:
            return process_window_twopass_plain(feed, state, cfg, tc,
                                                k_slots, fir_twopass,
                                                time_packed, packed14,
                                                words14_gather, fir_packed,
                                                words14_slab)
        return process_window_plain(feed, state, cfg, tc, k_slots,
                                    time_packed, packed14, fir_packed,
                                    words14_gather, words14_slab)
    return launch_kernel(feed, state, cfg, tc, k_slots, time_packed,
                         packed14, fir_twopass, fir_packed, words14_gather,
                         words14_slab, geometry)


# CUDA kernel launches (never the plain path): in all, per kernel, per
# kernel with the carry layout, and per kernel function
reset_launches()
