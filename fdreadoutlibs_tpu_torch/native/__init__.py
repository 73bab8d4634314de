"""ctypes bindings for the native C++ host codecs and latency buffer.

Copied from ``fdreadoutlibs_tpu/native/__init__.py:1-472`` (the entry
points the port calls; :475-503's DAPHNE relayout with its numpy codec
only); the sources ``framecodec.cpp`` and ``latency_buffer.cpp`` are
copies of that package's, but for the time2 relayout straight from WIBEth
frames (``relayout_time2_frames``), the port's own.  The library is built
from them at first use with ``g++`` into ``fdreadoutlibs_tpu_torch/_build/``
(gitignored), under a name keyed on the sources and flags, so an edited
source rebuilds and a stale library is never loaded.  Without a compiler
the codecs fall back to numpy (``available()`` reports which path is
active); ``chip_smoke.py`` refuses the fallback on the card's machine.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR, keyed_path

_DIR = Path(__file__).parent
_SOURCES = (_DIR / "latency_buffer.cpp", _DIR / "framecodec.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")
_lib = None
_tried = False


def _build() -> Path | None:
    """Compile the library unless its keyed file exists; None without a
    compiler or on a failed build."""
    out = keyed_path("fdreadout_native", _SOURCES, CXX_FLAGS)
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *map(str, _SOURCES)], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)               # atomic: readers never see a partial file
    return out


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    # latency buffer
    lib.lb_create.restype = ctypes.c_void_p
    lib.lb_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.lb_destroy.argtypes = [ctypes.c_void_p]
    lib.lb_insert.restype = ctypes.c_uint64
    lib.lb_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64]
    lib.lb_occupancy.restype = ctypes.c_uint64
    lib.lb_occupancy.argtypes = [ctypes.c_void_p]
    lib.lb_bounds.restype = ctypes.c_int
    lib.lb_bounds.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.lb_count_window.restype = ctypes.c_uint64
    lib.lb_count_window.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_uint64]
    lib.lb_extract_window.restype = ctypes.c_uint64
    lib.lb_extract_window.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_uint64, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.lb_extract_all.restype = ctypes.c_uint64
    lib.lb_extract_all.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
    lib.lb_pop_until.restype = ctypes.c_uint64
    lib.lb_pop_until.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.lb_pop_n.restype = ctypes.c_uint64
    lib.lb_pop_n.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.lb_key_at.restype = ctypes.c_int
    lib.lb_key_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.lb_cleanup_max_ts_diff.restype = ctypes.c_uint64
    lib.lb_cleanup_max_ts_diff.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    # frame codecs
    for name, argtypes in [
        ("wibeth_relayout_words14", [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_char_p]),
        ("wibeth_relayout_words14_mt", [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_uint64, ctypes.c_char_p,
                                        ctypes.c_uint64]),
        ("relayout_time2_chmajor", [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_char_p]),
        ("relayout_time2_chmajor_mt", [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_char_p,
                                       ctypes.c_uint64]),
        ("wibeth_relayout_time2_frames", [ctypes.c_char_p, ctypes.c_uint64,
                                          ctypes.c_uint64, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_uint64,
                                          ctypes.c_char_p]),
        ("wibeth_relayout_time2_frames_mt", [ctypes.c_char_p,
                                             ctypes.c_uint64, ctypes.c_uint64,
                                             ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_uint64, ctypes.c_char_p,
                                             ctypes.c_uint64]),
        ("protowib_relayout_time2", [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_char_p]),
    ]:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_char_p)


class NativeLatencyBuffer:
    """Native ordered buffer over fixed-size structured records; the key is
    the first 8 bytes (e.g. TP_DTYPE.time_start)."""

    def __init__(self, dtype: np.dtype, capacity: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dtype = np.dtype(dtype)
        assert self.dtype.itemsize >= 8
        self._h = lib.lb_create(self.dtype.itemsize, capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lb_destroy(self._h)
            self._h = None

    def insert(self, records: np.ndarray) -> int:
        records = np.ascontiguousarray(records, dtype=self.dtype)
        return int(self._lib.lb_insert(self._h, _ptr(records), len(records)))

    def occupancy(self) -> int:
        return int(self._lib.lb_occupancy(self._h))

    def bounds(self):
        lo, hi = ctypes.c_uint64(), ctypes.c_uint64()
        if not self._lib.lb_bounds(self._h, ctypes.byref(lo),
                                   ctypes.byref(hi)):
            return None
        return int(lo.value), int(hi.value)

    def oldest_ts(self):
        b = self.bounds()
        return None if b is None else b[0]

    def newest_ts(self):
        b = self.bounds()
        return None if b is None else b[1]

    def extract_window(self, start: int, end: int) -> np.ndarray:
        n = int(self._lib.lb_count_window(self._h, start, end))
        out = np.zeros(n, dtype=self.dtype)
        if n:
            got = int(self._lib.lb_extract_window(self._h, start, end,
                                                  _ptr(out), n))
            out = out[:got]
        return out

    def extract_all(self) -> np.ndarray:
        """Every record in key order (non-consuming).  NOT a window query:
        [start, end) cannot express 'include key UINT64_MAX'."""
        n = int(self._lib.lb_occupancy(self._h))
        out = np.zeros(n, dtype=self.dtype)
        if n:
            got = int(self._lib.lb_extract_all(self._h, _ptr(out), n))
            out = out[:got]
        return out

    def pop_until(self, ts: int) -> int:
        return int(self._lib.lb_pop_until(self._h, ts))

    def pop_n(self, n: int) -> int:
        """Drop the n oldest records (exact count, duplicate-key safe)."""
        return int(self._lib.lb_pop_n(self._h, n))

    def key_at(self, idx: int):
        """Key of the idx-th oldest record (None if out of range)."""
        k = ctypes.c_uint64()
        if not self._lib.lb_key_at(self._h, idx, ctypes.byref(k)):
            return None
        return int(k.value)

    def cleanup_max_ts_diff(self, max_diff: int) -> int:
        return int(self._lib.lb_cleanup_max_ts_diff(self._h, max_diff))


def relayout_words14(words: np.ndarray, out: np.ndarray = None,
                     nthreads: int = 1) -> np.ndarray:
    """Host-side words14 relayout: (L, T, 28) uint32 packed link rows ->
    (T, WR, 7, 128) int32 feed rows for the in-kernel-unpack kernel.  Uses
    the native codec when available, numpy otherwise."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    L, T, W = words.shape
    if W != 28:
        raise ValueError(f"expected (L, T, 28) WIBEth words, got {words.shape}")
    G = 4 * L
    WR = -(-G // 128)
    lib = load()
    if lib is not None:
        # 64-byte-aligned output enables the codec's non-temporal store
        # path; pass `out` to amortize the allocation across a stream
        if out is None:
            out = _aligned_empty((T, WR, 7, 128), np.int32)
        else:
            _check_out(out, (T, WR, 7, 128))
        if nthreads > 1:
            lib.wibeth_relayout_words14_mt(_ptr(words), L, T, _ptr(out),
                                           int(nthreads))
        else:
            lib.wibeth_relayout_words14(_ptr(words), L, T, _ptr(out))
        return out
    wt = words.transpose(1, 0, 2).reshape(T, G, 7)
    wt = np.pad(wt, ((0, 0), (0, WR * 128 - G), (0, 0)))
    res = np.ascontiguousarray(
        wt.reshape(T, WR, 128, 7).transpose(0, 1, 3, 2)).astype(np.int32)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res


def unpack14_words(words: np.ndarray) -> np.ndarray:
    """Vectorized numpy 14-bit unpack of (..., 7) uint32 word groups ->
    (..., 16) uint16 ADCs (the numpy mirror of the C++ unpack)."""
    w = np.asarray(words, dtype=np.uint32)
    out = np.empty(w.shape[:-1] + (16,), dtype=np.uint16)
    for r in range(16):
        bit = 14 * r
        j, sh = bit // 32, bit % 32
        v = w[..., j] >> np.uint32(sh)
        if sh + 14 > 32:
            v = v | (w[..., j + 1] << np.uint32(32 - sh))
        out[..., r] = v & np.uint32(0x3FFF)
    return out


def _aligned_empty(shape, dtype, align: int = 64) -> np.ndarray:
    """np.empty with a guaranteed 64-byte-aligned base: the native time2
    relayout uses non-temporal 64-byte stores only when the destination is
    cacheline-aligned — numpy's default allocator does not guarantee it."""
    n = int(np.prod(shape))
    itemsize = np.dtype(dtype).itemsize
    buf = np.empty(n * itemsize + align, dtype=np.uint8)
    off = (-buf.ctypes.data) % align
    return buf[off:off + n * itemsize].view(dtype).reshape(shape)


class FeedBuffer:
    """Double-buffered, 64-byte-aligned reusable outputs for the relayout
    codecs' ``out=`` parameter.  Two buffers (not one) so the array handed
    to the previous submit is never overwritten while its device transfer
    may still be in flight; a shape change replaces the slot."""

    def __init__(self):
        self._bufs = [None, None]
        self._flip = 0

    def get(self, shape) -> np.ndarray:
        shape = tuple(shape)
        self._flip ^= 1
        buf = self._bufs[self._flip]
        if buf is None or buf.shape != shape:
            buf = _aligned_empty(shape, np.int32)
            self._bufs[self._flip] = buf
        return buf


def _check_out(out: np.ndarray, shape: tuple) -> np.ndarray:
    """Validate a caller-supplied reusable output buffer."""
    if (not isinstance(out, np.ndarray) or out.dtype != np.int32
            or out.shape != shape or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError(
            f"out must be a writable C-contiguous int32 array of shape "
            f"{shape}, got {getattr(out, 'dtype', None)} "
            f"{getattr(out, 'shape', None)}")
    return out


def _pad_sublanes8(C: int) -> int:
    rows = -(-C // 128)
    return -(-rows // 8) * 8


def time2_feed_shape(n_links: int, n_ticks: int,
                     ch_per_link: int = 64, pad8: bool = True) -> tuple:
    """Canonical relayout_time2 output shape for an (L, T, .) word block.
    pad8=False ships only ceil(C/128) rows (the port's kernel reads
    unpadded rows)."""
    C = ch_per_link * n_links
    rows = _pad_sublanes8(C) if pad8 else -(-C // 128)
    return (n_ticks // 2, rows, 128)


def words14_feed_shape(n_links: int, n_ticks: int) -> tuple:
    """Canonical relayout_words14 output shape for an (L, T, 28) block."""
    return (n_ticks, -(-4 * n_links // 128), 7, 128)


def _pair_flat(adcs: np.ndarray, C: int, S: int) -> np.ndarray:
    """(T, C) int -> (T//2, S, 128) int32 time-paired canonical layout."""
    T = adcs.shape[0]
    flat = np.zeros((T, S * 128), dtype=np.int32)
    flat[:, :C] = adcs
    return (flat[0::2] | (flat[1::2] << 16)).reshape(T // 2, S, 128)


def relayout_time2(words: np.ndarray, ch_per_link: int = 64,
                   out: np.ndarray = None, nthreads: int = 1,
                   pad8: bool = True) -> np.ndarray:
    """Host-side 14-bit unpack + time-pairing: (L, T, nw) uint32 packed
    channel-major link rows (nw = ch_per_link*7/16: WIBEth 28, WIB2 112)
    -> (T//2, S, 128) int32 in the time2 canonical layout (channel
    c = ch_per_link*link + ch at flat lane c, value adc(2t) | adc(2t+1) <<
    16).  Uses the native codec when available, numpy otherwise."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if ch_per_link % 16:
        raise ValueError("ch_per_link must be a multiple of 16")
    nw = ch_per_link * 7 // 16
    L, T, W = words.shape
    if W != nw:
        raise ValueError(f"expected (L, T, {nw}) words for "
                         f"{ch_per_link} ch/link, got {words.shape}")
    if T % 2:
        raise ValueError("time2 relayout needs an even tick count")
    C = ch_per_link * L
    S = _pad_sublanes8(C) if pad8 else -(-C // 128)
    lib = load()
    if lib is not None:
        if out is None:
            out = _aligned_empty((T // 2, S, 128), np.int32)
        else:
            _check_out(out, (T // 2, S, 128))
        if nthreads > 1:
            lib.relayout_time2_chmajor_mt(_ptr(words), L, T, ch_per_link,
                                          S, _ptr(out), int(nthreads))
        else:
            lib.relayout_time2_chmajor(_ptr(words), L, T, ch_per_link, S,
                                       _ptr(out))
        return out
    adcs = unpack14_words(words.reshape(L, T, nw // 7, 7)) \
        .reshape(L, T, ch_per_link).transpose(1, 0, 2).reshape(T, C)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res


def relayout_time2_frames(frames: np.ndarray, out: np.ndarray = None,
                          nthreads: int = 1, pad8: bool = True) -> np.ndarray:
    """:func:`relayout_time2` of WIBEth frames' packed words, read where
    they lie: (L, N, 7200) uint8 frames -> (N*32, S, 128) int32.  Any
    such array whose last axis is contiguous is read in place (a batch
    sliced from a larger buffer too); no words copy is made.  Anything
    else raises ValueError.  Uses the native codec when available,
    :func:`relayout_time2` on the frames' words otherwise."""
    if (not isinstance(frames, np.ndarray) or frames.dtype != np.uint8
            or frames.ndim != 3 or frames.shape[2] != 7200
            or frames.strides[2] != 1):
        raise ValueError(
            f"expected (L, N, 7200) uint8 WIBEth frames with a contiguous "
            f"last axis, got {getattr(frames, 'dtype', type(frames))} "
            f"{getattr(frames, 'shape', None)} strides "
            f"{getattr(frames, 'strides', None)}")
    L, N, _ = frames.shape
    T = 64 * N
    lib = load()
    if lib is None:
        from ..formats import wibeth
        return relayout_time2(
            wibeth.frames_bytes_to_u32(frames).reshape(L, T, 28), out=out,
            nthreads=nthreads, pad8=pad8)
    shape = time2_feed_shape(L, T, pad8=pad8)
    S = shape[1]
    if out is None:
        out = _aligned_empty(shape, np.int32)
    else:
        _check_out(out, shape)
    link_stride, frame_stride = frames.strides[:2]
    if nthreads > 1:
        lib.wibeth_relayout_time2_frames_mt(
            _ptr(frames), L, N, link_stride, frame_stride, S, _ptr(out),
            int(nthreads))
    else:
        lib.wibeth_relayout_time2_frames(_ptr(frames), L, N, link_stride,
                                         frame_stride, S, _ptr(out))
    return out


def relayout_time2_protowib(frames: np.ndarray, chan_list,
                            out: np.ndarray = None,
                            pad8: bool = True) -> np.ndarray:
    """ProtoWIB plane-subset variant of relayout_time2: (T, 464) uint8
    whole frames + an in-frame channel list (the plane's
    COLLECTION/INDUCTION_INDEX_TO_CHAN register order) -> (T//2, S, 128)
    int32 canonical time-paired feed with plane-LOCAL channel indices.
    The host pays the 12-bit nibble decode; the device runs the time2 FIR
    datapath.  pad8=False ships only ceil(C/128) rows, as for
    relayout_time2."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 2 or frames.shape[1] != 464:
        raise ValueError(f"expected (T, 464) ProtoWIB frames, "
                         f"got {frames.shape}")
    T = frames.shape[0]
    if T % 2:
        raise ValueError("time2 relayout needs an even tick count")
    chan = np.ascontiguousarray(chan_list, dtype=np.uint16)
    if chan.ndim != 1 or chan.size == 0 or int(chan.max()) > 255:
        raise ValueError("chan_list must be 1-D in-frame channels (0..255)")
    C = chan.size
    S = _pad_sublanes8(C) if pad8 else -(-C // 128)
    lib = load()
    if lib is not None:
        if out is None:
            out = _aligned_empty((T // 2, S, 128), np.int32)
        else:
            _check_out(out, (T // 2, S, 128))
        lib.protowib_relayout_time2(_ptr(frames), T, _ptr(chan), C,
                                    S, _ptr(out))
        return out
    from ..formats import protowib as pw
    adcs = pw.get_adcs(frames)[:, chan].astype(np.int32)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res


def relayout_time2_daphne(words: np.ndarray, out: np.ndarray = None,
                          pad8: bool = True) -> np.ndarray:
    """DAPHNE-stream variant of relayout_time2 (the JAX package's
    ``native/__init__.py:475-503``): (L, N, 112) uint32 frame rows (each
    frame = 64 ticks x 4 channels, TIME-major 14-bit values) -> (N*32, S,
    128) int32 time-paired canonical layout, channel c = 4*link + ch.
    The numpy codec only (the port's native library carries no DAPHNE
    codec); pad8=False ships only ceil(C/128) rows, as for
    relayout_time2."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    L, N, W = words.shape
    if W != 112:
        raise ValueError(f"expected (L, N, 112) DAPHNE stream words, "
                         f"got {words.shape}")
    C = 4 * L
    S = _pad_sublanes8(C) if pad8 else -(-C // 128)
    adcs = unpack14_words(words.reshape(L, N, 16, 7)) \
        .reshape(L, N * 64, 4).transpose(1, 0, 2).reshape(N * 64, C)
    res = _pair_flat(adcs, C, S)
    if out is not None:
        _check_out(out, res.shape)[...] = res
        return out
    return res
