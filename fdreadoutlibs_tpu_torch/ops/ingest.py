"""Device ingest entry points, and the hit collection.

Counterparts of ``fdreadoutlibs_tpu/ops/ingest.py``:

* :func:`process_time2_feed` (:150-183) takes the host codec's time2 feed
  as it is, ``native.relayout_time2(pad8=False)``: (T/2, ceil(C/128), 128)
  int32 with adc(2t) | adc(2t+1) << 16 at flat lane c;
* :func:`process_packed_frames` (:35-62) and :func:`process_packed_wib2`
  (:190-209) unpack packed 14-bit frame words on the device and run the
  plain-sample datapath on a (T, C) int32 feed;
* :func:`process_packed_protowib` (:244-276) decodes ProtoWIB frames on
  the device and runs its two planes;
* :func:`process_packed_daphne` (:213-237) unpacks DAPHNE-stream frame
  words on the device (4 channels x 64 ticks per frame) and runs the
  plain-sample datapath;
* :func:`process_packed_frames_fused` (:84-104) and
  :func:`process_words14_feed` (:111-143) hand the packed words to the
  kernel, which unpacks them in-register (K4): the frame words as they
  are, or the host's words14 relayout (with ``slab=True`` unpacked into
  time2 words before the tick, K4b-slab);
* :func:`compact_on_device` (:279-296), :func:`unpack_compact` (:299-305)
  and :func:`collect_hits` (:308-331) turn the slot buffers into hits;
* :class:`StreamingIngest` (:334-619), the pipelined multi-link ingest.

The JAX path pads the channel axis to whole 8-row sublane tiles on the
device, and its fused kernels keep state and slots in the words14 lane
positions; both are TPU tile rules, so the port reads unpadded rows and
keeps canonical channel order on every feed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .chanstate import init_chanstate, seed_chanstate
from .config import TPGConfig
from .hits import HIT_DTYPE, hits_from_compact, sort_hits

from ..formats import daphne, protowib, wib2, wibeth
from ..utils.tuning import kernel_knobs
from .hits import compact_slots
from .tpg import auto_tc, pack_state, process_window


def _check_channels(state: torch.Tensor, n_channels: int) -> None:
    if state.shape[1] != n_channels:
        raise ValueError(f"state holds {state.shape[1]} channels, "
                         f"expected {n_channels}")


def process_time2_feed(W2: torch.Tensor, state: torch.Tensor,
                       cfg: TPGConfig, n_channels: int, tc: int = 512,
                       k_slots: int = 2, fir_twopass: int = 0, geometry=None):
    """Time-paired feed (T/2, S, 128) or (T/2, W) int32 -> (slots, nclose,
    new_state) like ``tpg.process_window``.  ``state`` is the (KSTATE, C)
    tensor of ``tpg.pack_state`` on the feed's device.  ``fir_twopass``
    (every entry here) selects the FIR schedule as
    ``tpg.process_window`` does."""
    if W2.dim() == 3:
        W2 = W2.reshape(W2.shape[0], -1)
    _check_channels(state, n_channels)
    return process_window(W2, state, cfg, tc=tc, k_slots=k_slots,
                          time_packed=True, fir_twopass=fir_twopass,
                          geometry=geometry)


def process_packed_frames(words: torch.Tensor, state: torch.Tensor,
                          cfg: TPGConfig, n_channels: int, tc: int = 512,
                          k_slots: int = 2, fir_twopass: int = 0, geometry=None):
    """WIBEth packed ingest: words (L, T, 28) int32 packed rows for L links
    of 64 channels -> device unpack -> (T, L*64) samples (channel =
    link*64 + c) -> the plain-sample datapath.  Returns (slots, nclose,
    new_state) like ``tpg.process_window``."""
    _check_channels(state, n_channels)
    L, T, _ = words.shape
    adcs = wibeth.unpack_frames(words.transpose(0, 1))      # (T, L, 64)
    return process_window(adcs.reshape(T, L * wibeth.N_CHANNELS), state,
                          cfg, tc=tc, k_slots=k_slots, time_packed=False,
                          fir_twopass=fir_twopass, geometry=geometry)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.int32) if words.dtype == torch.uint32 else words


def process_packed_frames_fused(words: torch.Tensor, state: torch.Tensor,
                                cfg: TPGConfig, n_channels: int,
                                tc: int = 512, k_slots: int = 2,
                                fir_twopass: int = 0, geometry=None):
    """WIBEth packed ingest with the in-kernel unpack (K4): words (L, T, 28)
    int32 packed rows for L links of 64 channels (channel = link*64 + c)
    go to the kernel as they are.  State, slots and nclose stay in
    canonical channel order (the JAX package's words14 positions are a TPU
    lane rule).  Returns (slots, nclose, new_state) like
    ``tpg.process_window``."""
    _check_channels(state, n_channels)
    if words.shape[0] * wibeth.N_CHANNELS != n_channels:
        raise ValueError(f"{words.shape[0]} links of {wibeth.N_CHANNELS} "
                         f"channels are not {n_channels} channels")
    return process_window(_as_int32(words), state, cfg, tc=tc,
                          k_slots=k_slots, time_packed=False,
                          packed14="frames", fir_twopass=fir_twopass,
                          geometry=geometry)


def process_words14_feed(W: torch.Tensor, state: torch.Tensor,
                         cfg: TPGConfig, n_channels: int, tc: int = 512,
                         k_slots: int = 2, slab: bool = False,
                         fir_twopass: int = 0, geometry=None):
    """Direct words14 feed (K4): W is (T, WR, 7, 128) int32 rows from
    ``native.relayout_words14`` (or :func:`pack_words14`), unpacked
    in-register by the kernel.  ``slab=True`` selects the two-stage slab
    schedule (K4b-slab): the rows are unpacked into a time2 slab in shared
    memory (the JAX package a chunk at a time, the kernel a 32-tick stage
    of its ring at a time), then the tick runs the time2 datapath on it;
    it needs tc % 16 == 0 and raises ValueError with ``fir_twopass``, as
    the JAX package does.  Same contract as
    :func:`process_packed_frames_fused`."""
    _check_channels(state, n_channels)
    return process_window(W, state, cfg, tc=tc, k_slots=k_slots,
                          time_packed=False, packed14="words14",
                          fir_twopass=fir_twopass, words14_slab=slab,
                          geometry=geometry)


def pack_words14(words: torch.Tensor) -> torch.Tensor:
    """(L, T, 28) int32 (or uint32) packed rows -> (T, WR, 7, 128) int32
    words14 rows: the counterpart of ``pack_words14_jnp`` (:65-77) and of
    the host's ``native.relayout_words14``."""
    words = _as_int32(words)
    L, T, _ = words.shape
    G = 4 * L                                   # 7-word channel groups
    WR = -(-G // 128)
    out = torch.zeros((T, WR * 128, 7), dtype=torch.int32,
                      device=words.device)
    out[:, :G] = words.transpose(0, 1).reshape(T, G, 7)
    return out.reshape(T, WR, 128, 7).transpose(2, 3).contiguous()


def process_packed_wib2(words: torch.Tensor, state: torch.Tensor,
                        cfg: TPGConfig, n_channels: int, tc: int = 512,
                        k_slots: int = 4, fir_twopass: int = 0, geometry=None):
    """WIB2 packed ingest: words (L, T, 112) int32 packed rows (each WIB2
    frame is ONE tick of 256 channels) -> device unpack -> (T, L*256)
    samples (channel = link*256 + c) -> the plain-sample datapath."""
    _check_channels(state, n_channels)
    L, T, _ = words.shape
    adcs = wib2.unpack_frames(words.transpose(0, 1))        # (T, L, 256)
    return process_window(adcs.reshape(T, L * wib2.N_CHANNELS), state, cfg,
                          tc=tc, k_slots=k_slots, time_packed=False,
                          fir_twopass=fir_twopass, geometry=geometry)


def process_packed_protowib(words: torch.Tensor, coll_state: torch.Tensor,
                            ind_state: torch.Tensor, coll_cfg: TPGConfig,
                            ind_cfg: TPGConfig, tc: int = 12,
                            k_slots: int = 4, fir_twopass: int = 0, geometry=None):
    """ProtoWIB packed ingest (ingest.py:244-276): words (T, 116) int32
    whole frames (one tick of 256 channels each) -> ONE device decode of
    the 12-bit codec -> the collection and induction planes as column
    gathers (``COLLECTION/INDUCTION_INDEX_TO_CHAN`` order) -> one launch per
    plane on the plain-sample datapath, each with its own threshold.

    Returns ((slots, nclose, new_coll_state), (slots, nclose,
    new_ind_state)) with plane-local channel indices."""
    _check_channels(coll_state, protowib.N_COLLECTION)
    _check_channels(ind_state, protowib.N_INDUCTION)
    adcs = protowib.unpack_frames(_as_int32(words))         # (T, 256)

    def run(plane_idx, state, cfg):
        idx = torch.as_tensor(plane_idx, device=adcs.device)
        return process_window(adcs.index_select(1, idx), state, cfg, tc=tc,
                              k_slots=k_slots, time_packed=False,
                              fir_twopass=fir_twopass, geometry=geometry)

    return (run(protowib.COLLECTION_INDEX_TO_CHAN, coll_state, coll_cfg),
            run(protowib.INDUCTION_INDEX_TO_CHAN, ind_state, ind_cfg))


def process_packed_daphne(words: torch.Tensor, state: torch.Tensor,
                          cfg: TPGConfig, n_channels: int, tc: int = 512,
                          k_slots: int = 4, fir_twopass: int = 0, geometry=None):
    """DAPHNE-stream packed ingest (:213-237): words (L, N, 112) int32
    packed rows — each stream frame is 64 ticks of 4 channels, time-major
    — for L links -> device unpack -> (T, L*4) samples (channel = link*4 +
    c, T = 64 N) -> the plain-sample datapath.  Returns (slots, nclose,
    new_state) like ``tpg.process_window``."""
    _check_channels(state, n_channels)
    L, N, _ = words.shape
    C = L * daphne.STREAM_N_CHANNELS
    if C != n_channels:
        raise ValueError(f"{L} links of {daphne.STREAM_N_CHANNELS} channels "
                         f"are not {n_channels} channels")
    T = N * daphne.STREAM_N_SAMPLES
    adcs = daphne.stream_unpack_frames(_as_int32(words))   # (L, N, 64, 4)
    flat = adcs.reshape(L, T, daphne.STREAM_N_CHANNELS).transpose(0, 1) \
        .reshape(T, C)
    return process_window(flat, state, cfg, tc=tc, k_slots=k_slots,
                          time_packed=False, fir_twopass=fir_twopass,
                          geometry=geometry)


def compact_on_device(slots, nclose, tick_offset: int, n_channels: int,
                      max_hits: int):
    """-> ONE (max_hits + 1, 6) int32 device tensor: the compact hit rows
    plus a trailer row [n_valid, dropped, 0...], so the host decode is a
    single device->host fetch.  Issues no host sync."""
    if slots.shape[-1] != n_channels:
        raise ValueError(f"slots hold {slots.shape[-1]} channels, "
                         f"expected {n_channels}")
    out, n, dropped = compact_slots(slots, nclose, max_hits,
                                    tick_offset=tick_offset)
    trailer = torch.zeros((1, 6), dtype=torch.int32, device=out.device)
    trailer[0, 0] = n
    trailer[0, 1] = dropped
    return torch.cat([out, trailer], dim=0)


def unpack_compact(packed):
    """compact_on_device output -> (canonical hit array, dropped count);
    the one device->host fetch + decode."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    n, dropped = int(packed[-1, 0]), int(packed[-1, 1])
    return hits_from_compact(packed[:-1], n), dropped


def decode_slots(slots, nclose, n_channels: int, tick_offset: int = 0):
    """Host decode of the port's slot layout -> (canonical hit array,
    dropped count): the counterpart of ``pallas_tpg.decode_pallas_hits``
    (:956-995).  slots (NCH, K, nw, C), nclose (NCH, C); nw = 2 is the
    no-peak FIR record [w0, end+1].  Dropped counts closes beyond the K
    slots of a channel's chunk."""
    slots = torch.as_tensor(slots).cpu().numpy()
    nclose = torch.as_tensor(nclose).cpu().numpy()
    nch, K, nw, _ = slots.shape
    flat = slots.reshape(nch * K, nw, -1)[:, :, :n_channels]
    k_idx, c_idx = np.nonzero(flat[:, -1] != 0)
    hits = np.zeros(len(k_idx), dtype=HIT_DTYPE)
    w0 = flat[k_idx, 0, c_idx]
    hits["channel"] = c_idx
    hits["end_tick"] = flat[k_idx, -1, c_idx] - 1 + tick_offset
    hits["charge"] = w0 >> 16
    hits["tover"] = w0 & 0xFFFF
    if nw == 3:
        w1 = flat[k_idx, 1, c_idx]
        hits["peak_adc"] = w1 >> 16
        hits["peak_time"] = w1 & 0xFFFF
    dropped = int(np.maximum(nclose[:, :n_channels] - K, 0).sum())
    return sort_hits(hits), dropped


def default_max_hits(n_channels: int) -> int:
    """The hits a compaction keeps of one batch when its caller sets no
    cap: max(2048, 2x the channel count)."""
    return max(2048, 2 * n_channels)


def collect_hits(slots, nclose, n_channels: int, max_hits: int | None = None,
                 tick_offset: int = 0, device: bool = True):
    """Kernel slot outputs -> (canonical hit array, dropped count).

    device=True compacts on the device and fetches only the hit list (one
    device->host copy); device=False fetches the slot buffers and decodes
    them on the host (:func:`decode_slots`, always lossless).  The two
    agree whenever the valid hits fit ``max_hits`` (None -> max(2048, 2x
    the channel count)); overflow beyond it is counted as dropped."""
    if max_hits is None:
        max_hits = default_max_hits(n_channels)
    if device:
        return unpack_compact(compact_on_device(slots, nclose, tick_offset,
                                                n_channels, max_hits))
    return decode_slots(slots, nclose, n_channels, tick_offset=tick_offset)


class StreamingIngest:
    """Pipelined streaming ingest over all links at once: each submit
    enqueues one batch's device work and returns the hits of the PREVIOUS
    batch (CUDA launches are asynchronous, so the host framing of batch
    k+1 overlaps the device work of batch k).  Port of the JAX package's
    ``StreamingIngest`` (:334-619) without its TPU knobs (``unroll``,
    ``interpret``), with an explicit ``device``
    ("cuda" runs the kernel and raises without a card; "cpu" runs the
    kernel's plain version).

    format="wibeth" (64 channels x 64 ticks per frame), "wib2" (256
    channels x 1 tick per frame; superchunk frames flattened per link) or
    "daphne_stream" (4 channels x 64 ticks per frame).
    Ingest modes: the packed words unpacked on the device (default),
    ``fused=True`` (WIBEth only: the in-kernel unpack, K4, fed by
    :meth:`submit_words` or, already in words14 order, by
    :meth:`submit_words14`) and ``time2=True`` (the host codec, then the
    time2 datapath; :meth:`submit_time2`).  ``device_compact=True``
    compacts the slot buffers to a hit list on the device, so only that
    list crosses to the host.  State, slots and hits are in canonical
    channel order in every mode.
    """

    def __init__(self, cfg: TPGConfig, n_links: int, tc: int | None = None,
                 k_slots: int = 4, format: str = "wibeth",
                 device_compact: bool = False, max_hits: int = 1024,
                 rs_memory_factor=None, fused: bool = False,
                 time2: bool = False, device="cuda",
                 fir_twopass: int | None = None):
        from ..apps.apa_readout import resolve_device
        if format not in ("wibeth", "wib2", "daphne_stream"):
            raise ValueError(f"unknown format {format!r}")
        if fused and format != "wibeth":
            raise ValueError("fused in-kernel unpack supports "
                             "format='wibeth' only")
        if fused and time2:
            raise ValueError("fused and time2 are exclusive ingest modes")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_links = n_links
        self.format = format
        self.fused = fused
        self.time2 = time2
        self._t2_bufs = native.FeedBuffer()   # host relayout output reuse
        self._ticks_per_row = 1            # ticks per packed word row
        # _unpack: the first row of each link's words -> its channels'
        # samples of tick 0, (L, channels per link)
        if format == "wibeth":
            self._ch_per_link = wibeth.N_CHANNELS
            self._fn = process_packed_frames_fused if fused \
                else process_packed_frames
            self._unpack = wibeth.unpack_frames
        elif format == "wib2":
            self._ch_per_link = wib2.N_CHANNELS
            self._fn = process_packed_wib2
            self._unpack = wib2.unpack_frames
        else:
            self._ch_per_link = daphne.STREAM_N_CHANNELS
            self._fn = process_packed_daphne
            self._ticks_per_row = daphne.STREAM_N_SAMPLES
            self._unpack = lambda w: daphne.stream_unpack_frames(w)[..., 0, :]
        self.n_channels = n_links * self._ch_per_link
        # explicit arguments win; else the tuned file (FDREADOUT_TUNED);
        # else the shipped table (ingest.py:398-407)
        knobs = kernel_knobs(cfg, tc)
        self.tc = knobs["tc"]
        self.fir_twopass = fir_twopass if fir_twopass is not None \
            else knobs["fir_twopass"]
        # the pipeline's geometry (the JAX class's unroll and block_sublanes)
        self.geometry = knobs["geometry"]
        self.k_slots = k_slots
        self.device_compact = device_compact
        self.max_hits = max_hits
        # per-channel RS memory factors (threshold-on-collection mixes
        # memoryless collection channels with RS induction channels);
        # scalar default = the cfg value
        if rs_memory_factor is None:
            rs_memory_factor = cfg.rs_memory_factor_x10
        else:
            rs_memory_factor = np.asarray(rs_memory_factor)
            if rs_memory_factor.shape not in ((), (self.n_channels,)):
                raise ValueError(
                    f"rs_memory_factor must be scalar or "
                    f"({self.n_channels},), got {rs_memory_factor.shape}")
            cfg.check_memory_factors(np.atleast_1d(rs_memory_factor))
        self.rs_memory_factor = rs_memory_factor
        self.state = None             # (KSTATE, C) on self.device
        self._pending = None          # (slots, nclose, tick_offset) or
                                      # the packed compact hits
        self.tick_offset = 0

    def _seed(self, first: np.ndarray) -> None:
        """Seed the carried state from each channel's first sample."""
        state = seed_chanstate(init_chanstate(self.n_channels), first,
                               self.rs_memory_factor)
        self.state = pack_state(state, self.n_channels, device=self.device)

    def _ensure_state(self, words0: np.ndarray) -> None:
        w = torch.from_numpy(np.ascontiguousarray(words0[:, 0])
                             .view(np.int32))
        self._seed(self._unpack(w).reshape(-1).numpy())

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(self.device)

    def _enqueue(self, slots, nclose, T: int) -> None:
        if self.device_compact:
            self._pending = compact_on_device(
                slots, nclose, self.tick_offset, self.n_channels,
                self.max_hits)
        else:
            self._pending = (slots, nclose, self.tick_offset)
        self.tick_offset += T

    def submit_words(self, words: np.ndarray):
        """words: (L, rows, W) uint32 packed rows (W=28 wibeth, 112 wib2
        and daphne_stream).  Returns the decoded hits of the PREVIOUS
        batch, or None."""
        if self.time2:
            return self.submit_time2(self.host_relayout_time2(words))
        T = words.shape[1] * self._ticks_per_row
        if self.state is None:
            self._ensure_state(words)
        out = self._collect() if self._pending is not None else None
        slots, nclose, self.state = self._fn(
            self._to_device(words), self.state, self.cfg, self.n_channels,
            tc=auto_tc(T, cap=self.tc), k_slots=self.k_slots,
            fir_twopass=self.fir_twopass, geometry=self.geometry)
        self._enqueue(slots, nclose, T)
        return out

    def submit_words14(self, W: np.ndarray):
        """Direct words14-ordered feed (fused mode only): W is
        (T, WR, 7, 128) int32 rows from ``native.relayout_words14``.
        Pipelining and collection match :meth:`submit_words`."""
        if not self.fused:
            raise ValueError(
                "submit_words14 requires StreamingIngest(fused=True)")
        T = int(W.shape[0])
        if self.state is None:
            self._ensure_state(self._words14_tick0(np.asarray(W[:1])))
        out = self._collect() if self._pending is not None else None
        slots, nclose, self.state = process_words14_feed(
            self._to_device(W), self.state, self.cfg, self.n_channels,
            tc=auto_tc(T, cap=self.tc), k_slots=self.k_slots,
            fir_twopass=self.fir_twopass, geometry=self.geometry)
        self._enqueue(slots, nclose, T)
        return out

    def host_relayout_time2(self, words: np.ndarray) -> np.ndarray:
        """(L, rows, W) packed words -> the time2 feed (T//2,
        ceil(C/128), 128) int32 (``native.relayout_time2(pad8=False)``:
        the port's kernel reads unpadded rows; the DAPHNE-stream codec
        ``native.relayout_time2_daphne`` for that format), into a reused
        ``native.FeedBuffer``."""
        if self.format == "daphne_stream":
            L, N, _ = words.shape
            shape = (N * daphne.STREAM_N_SAMPLES // 2,
                     -(-self.n_channels // 128), 128)
            return native.relayout_time2_daphne(
                words, out=self._t2_bufs.get(shape), pad8=False)
        L, T, _ = words.shape
        shape = native.time2_feed_shape(L, T, ch_per_link=self._ch_per_link,
                                        pad8=False)
        return native.relayout_time2(words, ch_per_link=self._ch_per_link,
                                     out=self._t2_bufs.get(shape),
                                     pad8=False)

    def submit_time2(self, W2: np.ndarray):
        """Time-paired host feed (canonical order, i.e. fused=False): W2 is
        (T//2, S, 128) int32 from :meth:`host_relayout_time2` or
        ``native.relayout_time2``.  Pipelining and collection match
        :meth:`submit_words`."""
        if self.fused:
            raise ValueError("submit_time2 requires "
                             "StreamingIngest(fused=False)")
        T = 2 * int(W2.shape[0])
        if self.state is None:
            # seed from tick 0 = the low 16-bit halves of the first row
            self._seed((np.asarray(W2[0]).reshape(-1)[: self.n_channels]
                        & 0xFFFF).astype(np.int32))
        out = self._collect() if self._pending is not None else None
        tc = auto_tc(T, cap=self.tc)
        # two ticks per word: tc must be even.  auto_tc can return an odd
        # divisor (e.g. T = 64*509 frames with cap 512 -> tc=509); take
        # the largest even divisor (T = 2*rows is always even).
        if tc % 2:
            tc = next((d for d in range(tc, 1, -1)
                       if T % d == 0 and d % 2 == 0), T)
        slots, nclose, self.state = process_time2_feed(
            torch.from_numpy(np.ascontiguousarray(W2)).to(self.device),
            self.state, self.cfg, self.n_channels, tc=tc,
            k_slots=self.k_slots, fir_twopass=self.fir_twopass,
            geometry=self.geometry)
        self._enqueue(slots, nclose, T)
        return out

    def _words14_tick0(self, W0: np.ndarray) -> np.ndarray:
        """Reverse the words14 relayout for ONE tick -> (L, 1, 28) packed
        words, so the state seeds from the first sample."""
        L = self.n_links
        wt = W0[0].transpose(0, 2, 1).reshape(-1, 7)[: 4 * L]  # (G, 7)
        return wt.reshape(L, 1, 28).astype(np.uint32)

    def submit(self, frames_links: np.ndarray):
        """frames_links: (L, N, frame_size) uint8.  Returns the decoded
        hits of the PREVIOUS batch (pipelined), or None on the first call."""
        L, N, _ = frames_links.shape
        if self.format == "wibeth":
            words = wibeth.frames_bytes_to_u32(
                frames_links.reshape(-1, wibeth.FRAME_SIZE)) \
                .reshape(L, N * wibeth.N_TIME_SAMPLES, 28)
        elif self.format == "wib2":
            words = np.ascontiguousarray(wib2.adc_region_u32(
                frames_links.reshape(-1, wib2.FRAME_SIZE))) \
                .reshape(L, N, wib2.ADC_WORDS)
        else:
            words = daphne.stream_frames_bytes_to_u32(
                frames_links.reshape(-1, daphne.STREAM_FRAME_SIZE)) \
                .reshape(L, N, daphne.STREAM_ADC_WORDS)
        return self.submit_words(words)

    def _collect(self):
        pending, self._pending = self._pending, None
        if self.device_compact:
            return unpack_compact(pending)
        slots, nclose, tick_offset = pending
        return decode_slots(slots, nclose, self.n_channels,
                            tick_offset=tick_offset)

    def flush(self):
        """Collect the final in-flight batch."""
        return self._collect() if self._pending is not None else None
