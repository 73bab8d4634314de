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

Two input encodings: time2 words (``time_packed=True``, tick 2j in the low
and 2j+1 in the high 16 bits) and one int32 sample per row
(``time_packed=False``).  On CUDA tensors it launches the hand-written
Hopper kernel (``csrc/tpg.cu``: K1 = time2 datapath, K2 = plain datapath,
K3 = the FIR family on either); on CPU tensors it runs the plain version,
:func:`process_window_plain`, which loops over ticks calling the JAX
package's ``ops/step.py::dispatch_tick`` through the torch namespace
(``ops/xp.py``).  There is no other route: a CUDA tensor that the kernel
cannot take raises.

The port's layouts drop the TPU tile blocking: state is (KSTATE, C) int32
on the device (the FIR ring in rows ``_FIR_ROW0..+8``, oldest-first),
slots (T/tc, K, nw, C), nclose (T/tc, C).  :func:`state_from_jax` /
:func:`state_to_jax` convert state to and from the JAX package's blocked
``pack_state`` stack, so both packages can start from one state.
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

# csrc/tpg.cu family codes
_FAMILY = {Algorithm.SIMPLE_THRESHOLD: 0, Algorithm.ABS_RS: 1,
           Algorithm.STANDARD_RS: 2, Algorithm.FIR: 3}


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


def state_from_jax(stack_np, n_channels: int, device="cpu") -> torch.Tensor:
    """JAX ``pack_state`` stack (NB, KSTATE, SUB, 128), as numpy -> the
    port's (KSTATE, C) tensor (canonical channel order, no positions)."""
    arr = np.asarray(stack_np).astype(np.int32)
    nb, kst, sub, lanes = arr.shape
    if kst != KSTATE or lanes != _LANES:
        raise ValueError(f"not a JAX state stack: shape {arr.shape}")
    flat = arr.transpose(1, 0, 2, 3).reshape(KSTATE, nb * sub * lanes)
    return torch.from_numpy(
        np.ascontiguousarray(flat[:, :n_channels])).to(device)


def state_to_jax(state: torch.Tensor,
                 block_sublanes: int | None = None) -> np.ndarray:
    """The port's (KSTATE, C) tensor -> the JAX ``pack_state`` stack
    (NB, KSTATE, SUB, 128) int32 numpy array, zero-padded to whole 8-row
    sublane tiles like ``pack_state``."""
    C = state.shape[1]
    rows = -(-C // _LANES)
    S = -(-rows // _SUBLANES) * _SUBLANES
    sub = block_sublanes or S
    if S % sub:
        raise ValueError(f"block_sublanes={sub} does not tile {S} rows")
    flat = np.zeros((KSTATE, S * _LANES), dtype=np.int32)
    flat[:, :C] = state.cpu().numpy()
    return flat.reshape(KSTATE, S // sub, sub, _LANES).transpose(1, 0, 2, 3) \
        .copy()


# ---- the plain version ----------------------------------------------------

def _check_window(feed, state, tc: int, k_slots: int, time_packed: bool):
    if feed.dim() != 2 or state.dim() != 2 or state.shape[0] != KSTATE:
        raise ValueError(f"expected feed (rows, W) and state ({KSTATE}, C), "
                         f"got {tuple(feed.shape)} and {tuple(state.shape)}")
    if feed.dtype != torch.int32 or state.dtype != torch.int32:
        raise ValueError("feed and state must be int32")
    C = state.shape[1]
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


def process_window_plain(feed: torch.Tensor, state: torch.Tensor,
                         cfg: TPGConfig, tc: int, k_slots: int,
                         time_packed: bool = True):
    """The plain PyTorch version of the kernel: a loop over ticks calling
    ``ops/step.py::dispatch_tick`` on (C,) int32 tensors, with the slot
    writes as masked stores.  The FIR ring rides the tick as a tuple of
    the 8 state rows, oldest-first (the Pallas kernel's carry).  Runs on
    any device; returns fresh tensors."""
    check_supported(cfg, state)
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


def kernels_of(cfg: TPGConfig, time_packed: bool) -> tuple:
    """ROADMAP.md's kernels that one launch runs: K1 (time2 datapath,
    threshold/RS families), K2 (plain-sample datapath), K3 (FIR family)."""
    is_fir = cfg.algorithm == Algorithm.FIR
    return (("K1",) if time_packed and not is_fir else ()) + \
        (() if time_packed else ("K2",)) + (("K3",) if is_fir else ())


def reset_launches() -> None:
    """Zero the launch counts (total and per kernel)."""
    process_window.launches = 0
    process_window.kernel_launches = {"K1": 0, "K2": 0, "K3": 0}


def _kernel_fn():
    fn = _build.load("tpg").tpg_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def launch_kernel(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                  tc: int, k_slots: int, time_packed: bool = True):
    """Launch ``csrc/tpg.cu`` on CUDA tensors (the wrapper's CUDA route).
    ``state`` is not modified: the kernel updates a copy in place and
    returns it.  Raises on anything the kernel does not take."""
    check_supported(cfg, state)
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device):
        raise ValueError("the tpg kernel needs feed and state on one CUDA "
                         f"device, got {feed.device} and {state.device}")
    if not (feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("feed and state must be contiguous")
    T, C = _check_window(feed, state, tc, k_slots, time_packed)
    taps, tap_exponent, adc_max, sigma_cap, thr_mult = _fir_args(cfg)
    n_chunks = T // tc
    nw = record_words(cfg)
    dev = state.device
    slots = torch.zeros((n_chunks, k_slots, nw, C), dtype=torch.int32,
                        device=dev)
    nclose = torch.empty((n_chunks, C), dtype=torch.int32, device=dev)
    new_state = state.clone()
    floor = cfg.algorithm != Algorithm.SIMPLE_THRESHOLD or cfg.threshold < 0
    err = _kernel_fn()(
        feed.data_ptr(), feed.shape[1], int(time_packed), n_chunks, tc,
        new_state.data_ptr(), C, slots.data_ptr(), nclose.data_ptr(),
        k_slots, _FAMILY[cfg.algorithm], int(cfg.peak_gated), int(floor),
        int(cfg.track_peaks), int(cfg.fir_avx_semantics), cfg.threshold,
        cfg.accumulator_limit, cfg.rs_scale_factor_x10, taps, tap_exponent,
        adc_max, sigma_cap, thr_mult,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tpg kernel launch failed: CUDA error {err}")
    process_window.launches += 1
    for k in kernels_of(cfg, time_packed):
        process_window.kernel_launches[k] += 1
    return slots, nclose, new_state


def process_window(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                   tc: int, k_slots: int, time_packed: bool = True):
    """Run the TPG over one window, carrying state.

    Args:
      feed: (T/2, W) int32 time-paired words (tick 2j in the low 16 bits,
        2j+1 in the high 16 bits, channel c at column c, W >= C) — or, with
        time_packed=False, (T, W) int32 samples.
      state: (KSTATE, C) int32, from :func:`pack_state`; not modified.
      tc: ticks per chunk (divides T; even when time_packed).
      k_slots: per-channel hit capacity per chunk.

    Returns (slots (T/tc, K, nw, C), nclose (T/tc, C), new_state).
    """
    if feed.device.type == "cpu" and state.device.type == "cpu":
        return process_window_plain(feed, state, cfg, tc, k_slots,
                                    time_packed)
    return launch_kernel(feed, state, cfg, tc, k_slots, time_packed)


# CUDA kernel launches (never the plain path): in all, and per kernel
reset_launches()
