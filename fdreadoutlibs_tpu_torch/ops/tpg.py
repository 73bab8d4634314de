"""The TPG kernel wrapper — counterpart of ``fdreadoutlibs_tpu/ops/pallas_tpg.py``.

``process_window`` runs the SWTPG tick over a window of samples for every
channel, carrying per-channel state, and emits hit records into per-chunk
K-slot buffers — the contract of ``pallas_tpg.process_window_pallas``:

* a close writes the record [charge<<16 | tover, peak<<16 | ptime, end+1]
  (``end`` = the tick within the window) into slot ``nclose[c]`` of its
  tc-tick chunk while ``nclose < K``; ``nclose`` counts every close, so
  closes beyond K per channel per chunk are dropped and visible;
* an empty slot is a zero end word.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/tpg_time2.cu``); on a CPU tensor it runs the plain version,
:func:`process_window_plain`, which loops over ticks calling the JAX
package's ``ops/step.py::tpg_tick`` through the torch namespace
(``ops/xp.py``).  There is no other route: a CUDA tensor that the kernel
cannot take raises.

The port's layouts drop the TPU tile blocking: state is (KSTATE, C) int32
on the device, slots (T/tc, K, nw, C), nclose (T/tc, C).
:func:`state_from_jax` / :func:`state_to_jax` convert state to and from the
JAX package's blocked ``pack_state`` stack, so both packages can start
from one state.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fdreadoutlibs_tpu.ops.chanstate import FIELDS, NSTATE
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu.ops.fixedpoint import wrap_i16
from fdreadoutlibs_tpu.ops.step import tpg_tick

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

# csrc/tpg_time2.cu family codes
_FAMILY = {Algorithm.SIMPLE_THRESHOLD: 0, Algorithm.ABS_RS: 1,
           Algorithm.STANDARD_RS: 2}


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
    ``ops/step.py::tpg_tick`` on (C,) int32 tensors, with the slot writes
    as masked stores.  Runs on any device; returns fresh tensors."""
    check_supported(cfg)
    T, C = _check_window(feed, state, tc, k_slots, time_packed)
    xp = TorchXP(state.device)
    fx = make_fx(xp)
    keys = live_fields(cfg)
    st = {k: state[_STATE_KEYS.index(k)] for k in keys}
    nw = record_words(cfg)
    n_chunks = T // tc
    # slot K is a sink for closes beyond capacity (dropped, but counted)
    slots = torch.zeros((n_chunks, k_slots + 1, nw, C), dtype=torch.int32,
                        device=state.device)
    nclose = torch.zeros((n_chunks, C), dtype=torch.int32,
                         device=state.device)
    x = feed[:, :C]
    for t in range(T):
        if time_packed:
            word = x[t // 2]
            s_raw = wrap_i16(word) if t % 2 == 0 else word >> 16
        else:
            s_raw = x[t]
        st, closed, rec = tpg_tick(st, s_raw, cfg, xp, fx=fx)
        chunk = t // tc
        words = torch.stack([
            (rec["charge"] << 16) | rec["tover"],
            (rec["peak_adc"] << 16) | rec["peak_time"],
            torch.full((C,), t + 1, dtype=torch.int32, device=state.device)])
        slot = torch.where(closed, torch.clamp(nclose[chunk], max=k_slots),
                           k_slots).long()
        slots[chunk].scatter_(0, slot.expand(nw, C)[None], words[None])
        nclose[chunk] += closed.to(torch.int32)
    new_state = state.clone()
    for k in keys:
        new_state[_STATE_KEYS.index(k)] = st[k]
    return slots[:, :k_slots].contiguous(), nclose, new_state


# ---- the kernel -----------------------------------------------------------

def _kernel_fn():
    fn = _build.load("tpg_time2").tpg_time2_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_time2_kernel(feed: torch.Tensor, state: torch.Tensor,
                        cfg: TPGConfig, tc: int, k_slots: int):
    """Launch ``csrc/tpg_time2.cu`` on CUDA tensors (the wrapper's CUDA
    route).  ``state`` is not modified: the kernel updates a copy in place
    and returns it.  Raises on anything the kernel does not take."""
    check_supported(cfg)
    if not (feed.is_cuda and state.is_cuda and feed.device == state.device):
        raise ValueError("the tpg_time2 kernel needs feed and state on one "
                         f"CUDA device, got {feed.device} and {state.device}")
    if not (feed.is_contiguous() and state.is_contiguous()):
        raise ValueError("feed and state must be contiguous")
    T, C = _check_window(feed, state, tc, k_slots, True)
    n_chunks = T // tc
    nw = record_words(cfg)
    dev = state.device
    slots = torch.zeros((n_chunks, k_slots, nw, C), dtype=torch.int32,
                        device=dev)
    nclose = torch.empty((n_chunks, C), dtype=torch.int32, device=dev)
    new_state = state.clone()
    floor = cfg.algorithm != Algorithm.SIMPLE_THRESHOLD or cfg.threshold < 0
    err = _kernel_fn()(
        feed.data_ptr(), feed.shape[1], n_chunks, tc // 2,
        new_state.data_ptr(), C, slots.data_ptr(), nclose.data_ptr(),
        k_slots, _FAMILY[cfg.algorithm], int(cfg.peak_gated), int(floor),
        cfg.threshold, cfg.accumulator_limit, cfg.rs_scale_factor_x10,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tpg_time2 kernel launch failed: CUDA error {err}")
    process_window.launches += 1
    return slots, nclose, new_state


def process_window(feed: torch.Tensor, state: torch.Tensor, cfg: TPGConfig,
                   tc: int, k_slots: int, time_packed: bool = True):
    """Run the TPG over one window, carrying state.

    Args:
      feed: (T/2, W) int32 time-paired words (tick 2j in the low 16 bits,
        2j+1 in the high 16 bits, channel c at column c, W >= C) — or, with
        time_packed=False, (T, W) int32 samples (CPU only: that datapath's
        kernel, K2 in ROADMAP.md, is not ported yet).
      state: (KSTATE, C) int32, from :func:`pack_state`; not modified.
      tc: ticks per chunk (divides T; even when time_packed).
      k_slots: per-channel hit capacity per chunk.

    Returns (slots (T/tc, K, nw, C), nclose (T/tc, C), new_state).
    """
    if feed.device.type == "cpu" and state.device.type == "cpu":
        return process_window_plain(feed, state, cfg, tc, k_slots,
                                    time_packed)
    if not time_packed:
        raise NotImplementedError(
            "the plain (time_packed=False) datapath has no CUDA kernel yet "
            "(K2 in ROADMAP.md); use the time2 feed")
    return launch_time2_kernel(feed, state, cfg, tc, k_slots)


process_window.launches = 0    # CUDA kernel launches (never the plain path)
