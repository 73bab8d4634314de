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
low and 2j+1 in the high 16 bits), one int32 sample per row
(``time_packed=False``), and packed 14-bit WIBEth words (``packed14=``
``"frames"`` for the (L, T, 28) frame words, ``"words14"`` for the host's
(T, WR, 7, 128) words14 relayout; :data:`PACKED14`).  On CUDA tensors it
launches the hand-written Hopper kernel (``csrc/tpg.cu``: K1 = time2
datapath, K2 = plain datapath, K3 = the FIR family on any, K4 = the
in-kernel 14-bit unpack); on CPU tensors it runs the plain version,
:func:`process_window_plain`, which loops over ticks calling the JAX
package's ``ops/step.py::dispatch_tick`` through the torch namespace
(``ops/xp.py``), after the torch unpack for packed words.  There is no
other route: a CUDA tensor that the kernel cannot take raises.

The port's layouts drop the TPU tile blocking: state is (KSTATE, C) int32
on the device (the FIR ring in rows ``_FIR_ROW0..+8``, oldest-first),
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

from fdreadoutlibs_tpu.ops.chanstate import FIELDS, NSTATE
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops.fir import default_taps
from fdreadoutlibs_tpu.ops.fixedpoint import wrap_i16
from fdreadoutlibs_tpu.ops.step import dispatch_tick

from ..formats import wibeth
from . import _build
from .xp import TorchXP, check_supported, make_fx

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

# csrc/tpg.cu family and encoding codes
_FAMILY = {Algorithm.SIMPLE_THRESHOLD: 0, Algorithm.ABS_RS: 1,
           Algorithm.STANDARD_RS: 2, Algorithm.FIR: 3}
_PLAIN, _TIME2, _PACKED14 = 0, 1, 2

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

def pack_state(state: dict, n_channels: int, device="cpu") -> torch.Tensor:
    """ChanState dict of (C,) arrays -> (KSTATE, C) int32 tensor."""
    out = np.zeros((KSTATE, n_channels), dtype=np.int32)
    for i, k in enumerate(_STATE_KEYS):
        out[i] = np.broadcast_to(np.asarray(state[k]), (n_channels,))
    fir = state.get("fir_prev")
    if fir is not None:
        out[_FIR_ROW0:_FIR_ROW0 + N_FIR_TAPS] = np.asarray(fir)
    return torch.from_numpy(out).to(device)


def unpack_state(state: torch.Tensor) -> dict:
    """(KSTATE, C) tensor -> ChanState-style dict of (C,) numpy arrays."""
    arr = state.cpu().numpy()
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
    port's (KSTATE, C) tensor in canonical channel order.  ``positions``
    is the channel -> flat-lane map the stack was packed with (the fused
    words14 kernels' ``words14_positions``); without it the stack must
    have the canonical row count, else this raises."""
    arr = np.asarray(stack_np)
    granule = 16 if arr.dtype.itemsize == 2 else _SUBLANES
    arr = arr.astype(np.int32)
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
    (NB, KSTATE, SUB, 128) int32 numpy array, zero-padded to whole 8-row
    sublane tiles like ``pack_state``; ``positions`` places channel c at
    flat lane positions[c] (the words14 layout)."""
    C = state.shape[1]
    n = _jax_lanes(C, positions, _SUBLANES)
    S = n // _LANES
    sub = block_sublanes or S
    if S % sub:
        raise ValueError(f"block_sublanes={sub} does not tile {S} rows")
    flat = np.zeros((KSTATE, n), dtype=np.int32)
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
    if state.dtype != torch.int32:
        raise ValueError("state must be int32")
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
        if feed.dtype != torch.int32:
            raise ValueError("feed must be int32")
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


def process_window_plain(feed: torch.Tensor, state: torch.Tensor,
                         cfg: TPGConfig, tc: int, k_slots: int,
                         time_packed: bool = True,
                         packed14: str | None = None):
    """The plain PyTorch version of the kernel: a loop over ticks calling
    ``ops/step.py::dispatch_tick`` on (C,) int32 tensors, with the slot
    writes as masked stores.  The FIR ring rides the tick as a tuple of
    the 8 state rows, oldest-first (the Pallas kernel's carry).  A packed
    14-bit feed is unpacked first (:func:`unpack_packed14`).  Runs on any
    device; returns fresh tensors."""
    check_supported(cfg, state)
    _check_window(feed, state, tc, k_slots, time_packed, packed14)
    if packed14 is not None:
        feed = unpack_packed14(feed, packed14, state.shape[1])
    T, C = _check_window(feed, state, tc, k_slots, time_packed)
    dev = state.device
    xp = TorchXP(dev)
    fx = make_fx(xp)
    keys = live_fields(cfg)
    st = {k: state[_STATE_KEYS.index(k)] for k in keys}
    is_fir = cfg.algorithm == Algorithm.FIR
    if is_fir:
        st["fir_prev"] = tuple(state[_FIR_ROW0 + j]
                               for j in range(N_FIR_TAPS))
    nw = record_words(cfg)
    n_chunks = T // tc
    # slot K is a sink for closes beyond capacity (dropped, but counted)
    slots = torch.zeros((n_chunks, k_slots + 1, nw, C), dtype=torch.int32,
                        device=dev)
    nclose = torch.zeros((n_chunks, C), dtype=torch.int32, device=dev)
    x = feed[:, :C]
    for t in range(T):
        if time_packed:
            word = x[t // 2]
            s_raw = wrap_i16(word) if t % 2 == 0 else word >> 16
        else:
            s_raw = x[t]
        st, closed, rec = dispatch_tick(st, s_raw, cfg, xp, fx=fx)
        chunk = t // tc
        words = [(rec["charge"] << 16) | rec["tover"]]
        if nw == 3:
            words.append((rec["peak_adc"] << 16) | rec["peak_time"])
        words.append(torch.full((C,), t + 1, dtype=torch.int32, device=dev))
        slot = torch.where(closed, torch.clamp(nclose[chunk], max=k_slots),
                           k_slots).long()
        slots[chunk].scatter_(0, slot.expand(nw, C)[None],
                              torch.stack(words)[None])
        nclose[chunk] += closed.to(torch.int32)
    new_state = state.clone()
    for k in keys:
        new_state[_STATE_KEYS.index(k)] = st[k]
    if is_fir:
        for j, row in enumerate(st["fir_prev"]):
            new_state[_FIR_ROW0 + j] = row
    return slots[:, :k_slots].contiguous(), nclose, new_state


# ---- the kernel -----------------------------------------------------------

_INT32 = (-(1 << 31), (1 << 31) - 1)


def kernels_of(cfg: TPGConfig, time_packed: bool,
               packed14: str | None = None) -> tuple:
    """ROADMAP.md's kernels that one launch runs: K1 (time2 datapath,
    threshold/RS families), K2 (plain-sample datapath), K4 (in-kernel
    14-bit unpack), K3 (FIR family, on any datapath)."""
    is_fir = cfg.algorithm == Algorithm.FIR
    if packed14 is not None:
        datapath = ("K4",)
    elif time_packed:
        datapath = () if is_fir else ("K1",)
    else:
        datapath = ("K2",)
    return datapath + (("K3",) if is_fir else ())


def reset_launches() -> None:
    """Zero the launch counts (total and per kernel)."""
    process_window.launches = 0
    process_window.kernel_launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


# csrc/tpg.cu::tpg_launch's C signature
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 8
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_int] * 9
             + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _kernel_fn():
    fn = _build.load("tpg").tpg_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _feed_layout(feed: torch.Tensor, time_packed: bool,
                 packed14: str | None):
    """(feed_stride, encoding, groups_per_row, group_outer, group_inner,
    word_stride) of ``csrc/tpg.cu::tpg_launch`` for a contiguous feed."""
    if packed14 == "frames":                 # (L, T, 28)
        T, W = feed.shape[1], feed.shape[2]
        return W, _PACKED14, 4, T * W, 7, 1
    if packed14 == "words14":                # (T, WR, 7, 128)
        WR = feed.shape[1]
        return WR * 7 * _LANES, _PACKED14, _LANES, 7 * _LANES, 1, _LANES
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
            device: int, stream):
    """Allocate the outputs beside ``state`` and call the C entry ``fn``
    on contiguous, checked tensors.  Returns (slots, nclose, new_state)."""
    T, C = _check_window(feed, state, tc, k_slots, time_packed, packed14)
    taps, tap_exponent, adc_max, sigma_cap, thr_mult = _fir_args(cfg)
    n_chunks = T // tc
    nw = record_words(cfg)
    slots = torch.zeros((n_chunks, k_slots, nw, C), dtype=torch.int32,
                        device=state.device)
    nclose = torch.empty((n_chunks, C), dtype=torch.int32,
                         device=state.device)
    new_state = state.clone()
    floor = cfg.algorithm != Algorithm.SIMPLE_THRESHOLD or cfg.threshold < 0
    err = fn(
        feed.data_ptr(), *_feed_layout(feed, time_packed, packed14),
        n_chunks, tc, new_state.data_ptr(), C, slots.data_ptr(),
        nclose.data_ptr(), k_slots, _FAMILY[cfg.algorithm],
        int(cfg.peak_gated), int(floor), int(cfg.track_peaks),
        int(cfg.fir_avx_semantics), cfg.threshold, cfg.accumulator_limit,
        cfg.rs_scale_factor_x10, taps, tap_exponent, adc_max, sigma_cap,
        thr_mult, device, stream)
    if err != 0:
        raise RuntimeError(f"tpg kernel launch failed: CUDA error {err}")
    return slots, nclose, new_state


def launch_kernel(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                  tc: int, k_slots: int, time_packed: bool = True,
                  packed14: str | None = None):
    """Launch ``csrc/tpg.cu`` on CUDA tensors (the wrapper's CUDA route).
    ``state`` is not modified: the kernel updates a copy in place and
    returns it.  Raises on anything the kernel does not take."""
    check_supported(cfg, state)
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device):
        raise ValueError("the tpg kernel needs feed and state on one CUDA "
                         f"device, got {feed.device} and {state.device}")
    if not (feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("feed and state must be contiguous")
    dev = state.device
    out = _launch(_kernel_fn(), feed, state, cfg, tc, k_slots, time_packed,
                  packed14,
                  dev.index if dev.index is not None
                  else torch.cuda.current_device(),
                  torch.cuda.current_stream(dev).cuda_stream)
    process_window.launches += 1
    for k in kernels_of(cfg, time_packed, packed14):
        process_window.kernel_launches[k] += 1
    return out


def process_window(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                   tc: int, k_slots: int, time_packed: bool = True,
                   packed14: str | None = None):
    """Run the TPG over one window, carrying state.

    Args:
      feed: (T/2, W) int32 time-paired words (tick 2j in the low 16 bits,
        2j+1 in the high 16 bits, channel c at column c, W >= C) — or, with
        time_packed=False, (T, W) int32 samples — or, with ``packed14``
        (time_packed=False), packed 14-bit words as int32: "frames" takes
        (L, T, 28) frame words (channel = link*64 + c), "words14" the
        (T, WR, 7, 128) rows of ``native.relayout_words14``; C % 16 == 0.
      state: (KSTATE, C) int32, from :func:`pack_state`; not modified.
      tc: ticks per chunk (divides T; even when time_packed).
      k_slots: per-channel hit capacity per chunk.

    Returns (slots (T/tc, K, nw, C), nclose (T/tc, C), new_state).
    """
    if feed.device.type == "cpu" and state.device.type == "cpu":
        return process_window_plain(feed, state, cfg, tc, k_slots,
                                    time_packed, packed14)
    return launch_kernel(feed, state, cfg, tc, k_slots, time_packed,
                         packed14)


# CUDA kernel launches (never the plain path): in all, and per kernel
reset_launches()
