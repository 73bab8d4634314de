"""Full-APA / multi-device SWTPG pipeline.

Counterpart of ``fdreadoutlibs_tpu/parallel/apa.py:1-476``: one step
consumes a batch of packed WIBEth ADC words for L links, runs unpack + the
SWTPG tick with carried per-channel state and compacts hits on the device,
link by link, with the links split over the 'link' axis of a mesh
(``parallel/mesh.py``).  There are no collectives in the hot loop: channels
are independent, and the hit compaction stays shard-local.

The JAX step is a ``shard_map`` over the mesh; here one controller runs the
same per-shard body (:73-192) on each shard's links, on that shard's device
and on a CUDA stream of its own, so shards on one card overlap.  The step
takes the whole (L, T, 28) batch and returns whole (L, max_hits, 6) hits,
(L,) n_hits, the total and the dropped count, and the new state, as the JAX
step does.  Arrays split over the mesh are :class:`mesh.Sharded`:
``np.asarray`` gathers them.  The psums (:147, :158) are sums of the
shards' 0-d tensors on the first shard's device; nothing syncs the host
until the caller reads a result (``APAPipeline.process`` reads the total
and the dropped count in one fetch a step).

Per shard (backend="pallas"): the canonical ingest is
``ops/ingest.process_packed_frames`` (K2, K3 for FIR), ``fused_unpack``
``process_packed_frames_fused`` (K4; the JAX words14 lane positions are a
TPU tile rule, so the port stays in canonical channel order) and
``time2_feed`` ``process_time2_feed`` (K1, K3 for FIR) on the shard's
``native.relayout_time2(pad8=False)`` feed; then each link's K slots of
every chunk are compacted apart (``ops/hits.compact_slot_words`` with a
leading link axis) under ``max_hits_per_link``, and ``dropped`` counts the
closes beyond K per chunk and the stored records beyond the per-link cap,
as :135-158 do.  backend="scan" runs ``ops/scan.process_window_scan`` and
the per-link ``compact_hits_device``.  tc is ``auto_tc(T)``, K
``k_slots``, the FIR schedule ``kernel_knobs``' ``fir_twopass``, as in the
JAX step.  On CPU tensors every shard runs the kernels' plain versions.

The JAX ``interpret`` flag (Pallas interpret mode) has no counterpart: the
mesh's device chooses the kernel or its plain version.

The carried state is a (KSTATE, C_shard) stack a shard (``ops/tpg``'s
layout); ``APAPipeline.state`` reads it as the JAX dict, (L, 64) a key and
``fir_prev`` (L, 8, 64), each a :class:`Sharded` of views on the shards'
devices, and assigning a dict (a checkpoint, :func:`state_from_jax`)
packs it back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..formats import wibeth
from ..formats.bitpack import unpack_14bit
from ..ops import TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.hits import compact_slot_words
from ..ops.ingest import (process_packed_frames, process_packed_frames_fused,
                          process_time2_feed)
from ..ops.scan import STATE_KEYS, compact_hits_device, process_window_scan
from ..ops.tpg import N_FIR_TAPS, auto_tc, record_words
from ..utils.tuning import kernel_knobs
from .mesh import LinkMesh, Sharded

N_CH = wibeth.N_CHANNELS
# the stack's rows: STATE_KEYS in order, fir_prev's taps last
_ROWS = STATE_KEYS[:-1]
_FIR0 = len(_ROWS)


class _ShardBody:
    """The per-shard step body shared by the 1-D and 2-D steps
    (``_make_local``, :73-192): :meth:`kernel` runs the tick on one
    shard's links, :meth:`compact` turns its outputs into per-link hits and
    the shard's counts."""

    def __init__(self, cfg: TPGConfig, max_hits_per_link: int, backend: str,
                 k_slots: int, fused_unpack: bool, time2_feed: bool,
                 fir_twopass: int | None):
        knobs = kernel_knobs(cfg)
        if fir_twopass is None:
            # tuned-file/shipped FIR schedule choice (utils.tuning)
            fir_twopass = knobs["fir_twopass"]
        # the pipeline's geometry, as the JAX body takes unroll
        self.geometry = knobs["geometry"]
        self.cfg = cfg
        self.max_hits = max_hits_per_link
        self.backend = backend
        self.k_slots = k_slots
        self.fused_unpack = fused_unpack
        self.time2_feed = time2_feed
        self.fir_twopass = int(fir_twopass)

    def kernel(self, feed: torch.Tensor, stack: torch.Tensor):
        """feed: the shard's (Lloc, T, 28) int32 words, or its (T/2, S, 128)
        time2 feed; stack: its (KSTATE, C) state.  -> (outputs, new
        stack): pallas (slots, nclose), scan (closed, records)."""
        C = stack.shape[1]
        if self.backend != "pallas":
            Lloc, T, _ = feed.shape
            adcs = wibeth.unpack_frames(feed.transpose(0, 1)).reshape(T, C)
            closed, records, st = process_window_scan(
                adcs, _scan_state(stack), self.cfg)
            new = torch.cat([torch.stack([st[k] for k in _ROWS]),
                             st["fir_prev"]])
            return (closed, records), new
        T = 2 * feed.shape[0] if self.time2_feed else feed.shape[1]
        fn = process_time2_feed if self.time2_feed else \
            process_packed_frames_fused if self.fused_unpack else \
            process_packed_frames
        slots, nclose, new = fn(feed, stack, self.cfg, C, tc=auto_tc(T),
                                k_slots=self.k_slots,
                                fir_twopass=self.fir_twopass,
                                geometry=self.geometry)
        return (slots, nclose), new

    def compact(self, out, n_links: int):
        """-> (hits (Lloc, max_hits, 6), n_hits (Lloc,), total, dropped),
        the counts 0-d tensors, on the shard's device."""
        if self.backend != "pallas":
            closed, records = out
            T = closed.shape[0]

            def per_link(x):
                return x.reshape(T, n_links, N_CH).transpose(0, 1)

            hits, n_hits, drops = compact_hits_device(
                per_link(closed), {f: per_link(r) for f, r in records.items()},
                max_hits=self.max_hits)
            return hits, n_hits, n_hits.sum(), drops.sum()
        slots, nclose = out
        K = self.k_slots
        nw = record_words(self.cfg)
        # (n_chunks, K, nw, C) -> per link (Lloc, n_chunks*K, nw, 64): the
        # per-chunk slots fold into one wider slot axis (records carry the
        # tick within the batch)
        w = slots.reshape(-1, nw, n_links, N_CH).permute(2, 0, 1, 3)
        hits, n_hits = compact_slot_words(
            w[:, :, 0], w[:, :, 1] if nw == 3 else None, w[:, :, -1],
            self.max_hits)
        # both loss modes: closes beyond the K slots of a chunk, and stored
        # records beyond the per-link compaction bound (:148-158)
        cap_drops = torch.clamp(nclose - K, min=0).sum()
        stored = torch.clamp(nclose, max=K).sum(dim=0) \
            .reshape(n_links, N_CH).sum(dim=1)
        trunc = torch.clamp(stored - self.max_hits, min=0).sum()
        return hits, n_hits, n_hits.sum(), cap_drops + trunc


def _scan_state(stack: torch.Tensor) -> dict:
    """A (KSTATE, C) stack -> the scan's dict of (C,) rows and fir_prev."""
    st = {k: stack[i] for i, k in enumerate(_ROWS)}
    st["fir_prev"] = stack[_FIR0:]
    return st


class _GridStep:
    """One step over the mesh's grid of shards: the per-shard body on each
    shard's device and CUDA stream, the streams joined before the totals.

    ``step(words, state)`` -> (hits, n_hits, totals, dropped, new_state) as
    the JAX step; :meth:`run` is the same on the shards' state stacks."""

    def __init__(self, mesh: LinkMesh, body: _ShardBody):
        self.mesh = mesh
        self.body = body
        self.grid = mesh.devices.shape
        self.cells = list(np.ndindex(self.grid))
        self._streams = {}

    def device(self, cell) -> torch.device:
        return self.mesh.devices[cell]

    def _cut(self, x, cell):
        """The shard of the batch: its links of (..., L, T, 28) words, or
        its (T/2, S, 128) feed of (..., D, T/2, S, 128) time2 feeds."""
        if self.body.time2_feed:
            return x[cell]
        n = x.shape[len(cell) - 1] // self.grid[-1]
        d = cell[-1]
        return x[cell[:-1] + (slice(d * n, (d + 1) * n),)]

    def upload(self, words: np.ndarray) -> list:
        """The batch (uint32 or int32 on the host) -> one int32 tensor a
        shard on its device: one copy a device when every shard is on one
        device, else one a shard."""
        words = np.ascontiguousarray(words)
        if words.dtype == np.uint32:
            words = words.view(np.int32)

        def to(x, dev):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        devs = set(self.mesh.devices.flat)
        if len(devs) == 1:
            whole = to(words, next(iter(devs)))
            return [self._cut(whole, c) for c in self.cells]
        return [to(self._cut(words, c), self.device(c)) for c in self.cells]

    def on_streams(self, fn, *per_cell) -> list:
        """fn(*args of cell i) for each cell, on the cell's own CUDA
        stream (after the work already queued on its device), in order;
        on the CPU one after another."""
        outs = []
        for i, cell in enumerate(self.cells):
            dev = self.device(cell)
            args = [a[i] for a in per_cell]
            if dev.type != "cuda":
                outs.append(fn(*args))
                continue
            s = self._streams.get(cell)
            if s is None:
                s = self._streams[cell] = torch.cuda.Stream(device=dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                outs.append(fn(*args))
        return outs

    def join(self) -> None:
        """The devices' current streams wait for every shard's stream."""
        for cell, s in self._streams.items():
            torch.cuda.current_stream(self.device(cell)).wait_stream(s)

    def run(self, words, stacks: list):
        """-> (hits, n_hits, totals, dropped, new stacks): hits and n_hits
        :class:`Sharded`, totals and dropped 0-d (1-D mesh) or (A,) (2-D)
        on the first shard's device, the new stacks one a shard."""
        feeds = self.upload(words)
        kern = self.on_streams(self.body.kernel, feeds, stacks)
        n_links = [s.shape[1] // N_CH for s in stacks]
        comp = self.on_streams(self.body.compact, [o for o, _ in kern],
                               n_links)
        self.join()
        return self.gather(comp) + ([s for _, s in kern],)

    def gather(self, comp) -> tuple:
        """Per-shard (hits, n_hits, total, dropped) -> (hits, n_hits,
        totals, dropped) over the grid (the psum over 'link', :147, :158)."""
        lead = (None,) if len(self.grid) == 2 else ()
        hits = Sharded([c[0][lead] for c in comp], self.grid)
        n_hits = Sharded([c[1][lead] for c in comp], self.grid)
        dev0 = self.device(self.cells[0])

        def psum(j):
            per = torch.stack([c[j].to(dev0) for c in comp])
            return per.reshape(self.grid).sum(dim=-1).to(torch.int64)

        return hits, n_hits, psum(2), psum(3)

    def stacks(self, state: dict) -> list:
        """A state dict over the whole grid (arrays as numpy, tensors, or
        :class:`Sharded`) -> the (KSTATE, C) stack of each shard on its
        device."""
        parts = {}
        for k in STATE_KEYS:
            v = state[k]
            parts[k] = list(v.shards.flat) if isinstance(v, Sharded) and \
                v.shards.shape == self.grid else \
                [torch.from_numpy(np.array(p, dtype=np.int32))
                 for p in _split(np.asarray(v), self.grid)]
        out = []
        for i, cell in enumerate(self.cells):
            dev = self.device(cell)
            rows = [parts[k][i].to(dev).reshape(1, -1) for k in _ROWS]
            fir = parts["fir_prev"][i].to(dev)
            rows.append(fir.reshape(-1, N_FIR_TAPS, N_CH).transpose(0, 1)
                        .reshape(N_FIR_TAPS, -1))
            out.append(torch.cat(rows).to(torch.int32))
        return out

    def state(self, stacks: list) -> dict:
        """The shards' stacks -> the JAX state dict: (L, 64) a key and
        fir_prev (L, 8, 64) (with a leading APA axis on a 2-D mesh), each a
        :class:`Sharded` of views of the stacks."""
        lead = (1,) if len(self.grid) == 2 else ()

        def key(stack, i):
            C = stack.shape[1]
            if i == _FIR0:
                return stack[_FIR0:].reshape(-1, C // N_CH, N_CH) \
                    .transpose(0, 1).reshape(lead + (C // N_CH, -1, N_CH))
            return stack[i].reshape(lead + (C // N_CH, N_CH))

        return {k: Sharded([key(s, i) for s in stacks], self.grid)
                for i, k in enumerate(STATE_KEYS)}

    def __call__(self, words, state: dict):
        hits, n_hits, totals, dropped, new = self.run(words,
                                                      self.stacks(state))
        return hits, n_hits, totals, dropped, self.state(new)


def _split(arr: np.ndarray, grid: tuple) -> list:
    """The whole array -> its shards in grid order, grid axis i splitting
    array axis i evenly."""
    parts = [arr]
    for ax, n in enumerate(grid):
        if arr.shape[ax] % n:
            raise ValueError(f"axis {ax} of {arr.shape} does not split "
                             f"over {n} shards")
        parts = [p for q in parts for p in np.split(q, n, axis=ax)]
    return parts


def state_from_jax(state_np: dict, mesh: LinkMesh) -> dict:
    """A JAX pipeline's state dict (arrays as numpy: (L, 64) a key and
    fir_prev (L, 8, 64), with a leading APA axis for a detector) -> the
    port's state split over ``mesh``, each key a :class:`Sharded` on the
    shards' devices (assign it to ``APAPipeline.state`` or
    ``DetectorPipeline.state``)."""
    grid = mesh.devices.shape
    out = {}
    for k in STATE_KEYS:
        parts = _split(np.asarray(state_np[k], dtype=np.int32), grid)
        out[k] = Sharded([torch.from_numpy(np.array(p)).to(mesh.devices[c])
                          for p, c in zip(parts, np.ndindex(grid))], grid)
    return out


def _check_backend(backend: str, fused_unpack: bool,
                   time2_feed: bool) -> None:
    if backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if fused_unpack and backend != "pallas":
        raise ValueError("fused_unpack requires backend='pallas'")
    if time2_feed and backend != "pallas":
        raise ValueError("time2_feed requires backend='pallas'")
    if time2_feed and fused_unpack:
        raise ValueError("fused_unpack and time2_feed are exclusive")


def make_apa_step(mesh: LinkMesh, cfg: TPGConfig,
                  max_hits_per_link: int = 512, backend: str = "scan",
                  k_slots: int = 8, fused_unpack: bool = False,
                  time2_feed: bool = False, fir_twopass: int | None = None):
    """Build the multi-device step (:195-227).

    step(words (L, T, 28) uint32 or int32, state {k: (L, 64) int32}) ->
      (hits (L, max_hits, 6) int32, n_hits (L,) int32, total_hits 0-d,
       dropped 0-d, new_state) — ``dropped`` counts closes lost to
      per-channel capacity (K-slot chunks and the per-link bound in the
      pallas backend, max_hits_per_link overflow in the scan backend).

    Links split over the mesh 'link' axis.  time2_feed=True changes the
    first argument to per-shard time-paired feeds (D, T//2, S_loc, 128)
    int32 (``native.relayout_time2(pad8=False)`` of each shard's links)."""
    if mesh.axis_names != ("link",):
        raise ValueError(f"make_apa_step needs a ('link',) mesh, got "
                         f"{mesh.axis_names}")
    _check_backend(backend, fused_unpack, time2_feed)
    return _GridStep(mesh, _ShardBody(cfg, max_hits_per_link, backend,
                                      k_slots, fused_unpack, time2_feed,
                                      fir_twopass))


def make_detector_step(mesh: LinkMesh, cfg: TPGConfig,
                       max_hits_per_link: int = 512, backend: str = "scan",
                       k_slots: int = 8, fused_unpack: bool = False,
                       time2_feed: bool = False,
                       fir_twopass: int | None = None):
    """Build the DETECTOR-scale step over a 2-D ('apa', 'link') mesh
    (:230-273): N independent APAs, each split over its own link-axis
    device group (SURVEY §2.7; a far-detector module is 150 APAs).

    step(words (A, L, T, 28), state {k: (A, L, 64) int32}) ->
      (hits (A, L, max_hits, 6), n_hits (A, L), apa_totals (A,),
       dropped (A,), new_state)

    APAs never interact: the sums run over 'link' only, which makes the
    aggregates per APA.  With time2_feed=True the first argument is
    per-shard feeds (A, D_link, T//2, S_loc, 128)."""
    if mesh.axis_names != ("apa", "link"):
        raise ValueError(f"make_detector_step needs an ('apa', 'link') "
                         f"mesh, got {mesh.axis_names}")
    _check_backend(backend, fused_unpack, time2_feed)
    return _GridStep(mesh, _ShardBody(cfg, max_hits_per_link, backend,
                                      k_slots, fused_unpack, time2_feed,
                                      fir_twopass))


class _Pipeline:
    """What the two pipelines share: the carried state as the shards'
    stacks, read and assigned as the JAX state dict."""

    step: _GridStep

    @property
    def state(self) -> Optional[dict]:
        """{k: Sharded (L, 64)} (fir_prev (L, 8, 64); a leading APA axis
        for a detector), views of the carried stacks; None until
        seeded."""
        return None if self._stacks is None else self.step.state(self._stacks)

    @state.setter
    def state(self, value: Optional[dict]) -> None:
        self._stacks = None if value is None else self.step.stacks(value)

    def _seed(self, first: np.ndarray, rs_memory_factor) -> None:
        """Seed the state from the first sample of each channel, (..., L,
        64) with a leading APA axis for a detector, on the host
        (``ProcessingInfo::setState``), then split it over the mesh."""
        if rs_memory_factor is None:
            rs_memory_factor = self.cfg.rs_memory_factor_x10
        self.cfg.check_memory_factors(rs_memory_factor)
        first = np.asarray(first, dtype=np.int32)
        lead, L = first.shape[:-2], first.shape[-2]
        per_apa = [seed_chanstate(init_chanstate(L * N_CH), f,
                                  rs_memory_factor)
                   for f in first.reshape(-1, L * N_CH)]

        def link_major(k):
            v = np.stack([np.asarray(st[k], dtype=np.int32)
                          for st in per_apa])
            if k == "fir_prev":   # (A, NTAPS, C) -> (..., L, NTAPS, 64)
                return v.reshape(-1, N_FIR_TAPS, L, N_CH) \
                    .transpose(0, 2, 1, 3).reshape(lead + (L, -1, N_CH))
            return v.reshape(lead + (L, N_CH))

        self.state = {k: link_major(k) for k in STATE_KEYS}


class APAPipeline(_Pipeline):
    """Streaming APA pipeline: carries the split per-channel state across
    batches; the host feeds packed frame batches per link (:276-376)."""

    def __init__(self, n_links: int, cfg: TPGConfig,
                 mesh: Optional[LinkMesh] = None,
                 max_hits_per_link: int = 512, backend: str = "scan",
                 fused_unpack: bool = False, time2_feed: bool = False,
                 codec_threads: int = 1):
        from .mesh import make_link_mesh
        self.mesh = mesh or make_link_mesh()
        self.n_links = n_links
        if n_links % self.mesh.devices.size:
            raise ValueError("links must divide evenly over devices")
        self.cfg = cfg
        self.time2_feed = time2_feed
        # host relayout codec fan-out (native.relayout_time2 nthreads=)
        self.codec_threads = codec_threads
        self._feed_buf = None              # lazy native.FeedBuffer
        self.step = make_apa_step(self.mesh, cfg, max_hits_per_link,
                                  backend=backend,
                                  fused_unpack=fused_unpack,
                                  time2_feed=time2_feed)
        self._stacks = None
        self.dropped_hits = 0      # cumulative capacity-dropped closes

    def init_state(self, first_samples: np.ndarray,
                   rs_memory_factor=None) -> None:
        """Seed per-channel state from the first time sample of each link
        ((L, 64) array; ProcessingInfo::setState semantics)."""
        self._seed(np.reshape(first_samples, (self.n_links, N_CH)),
                   rs_memory_factor)

    def host_feed(self, words: np.ndarray):
        """The batch as the step takes it: the words, or with time2_feed
        each shard's ``native.relayout_time2(pad8=False)`` feed, stacked
        (D, T//2, S_loc, 128) in a reused ``native.FeedBuffer``."""
        if not self.time2_feed:
            return words
        D = self.mesh.devices.size
        Lloc = self.n_links // D
        T = words.shape[1]
        if self._feed_buf is None:
            self._feed_buf = native.FeedBuffer()
        feeds = self._feed_buf.get(
            (D,) + native.time2_feed_shape(Lloc, T, pad8=False))
        for d in range(D):
            native.relayout_time2(
                np.ascontiguousarray(words[d * Lloc:(d + 1) * Lloc]),
                out=feeds[d], nthreads=self.codec_threads, pad8=False)
        return feeds

    def process(self, words: np.ndarray):
        """words: (L, T, 28) uint32 packed ADC rows for T ticks per link.
        Returns (hits (L, max_hits, 6), n_hits (L,), total int).  With
        time2_feed=True the host relayouts each shard's links first; a
        time2-capable source can call :meth:`process_feed` directly."""
        if self._stacks is None:
            # seed from the first tick of this batch, on the host
            self.init_state(unpack_14bit(np.asarray(words[:, 0]), N_CH)
                            .astype(np.int32))
        if self.time2_feed:
            return self.process_feed(self.host_feed(words))
        return self._run(words)

    def process_feed(self, feeds: np.ndarray):
        """feeds: (D, T//2, S_loc, 128) int32 per-shard time-paired feeds
        (time2_feed mode; state must already be seeded)."""
        if not self.time2_feed or self._stacks is None:
            raise ValueError("process_feed needs time2_feed=True and a "
                             "seeded state")
        return self._run(feeds)

    def _run(self, batch):
        hits, n_hits, total, dropped, self._stacks = self.step.run(
            batch, self._stacks)
        total, dropped = torch.stack([total, dropped]).tolist()
        self.dropped_hits += dropped
        return hits, n_hits, total


class DetectorPipeline(_Pipeline):
    """Detector-scale streaming pipeline: N independent APAs over a 2-D
    ('apa', 'link') mesh, each APA split over its own link-axis device
    group (:379-476).  Per-APA hit totals come out of the step's sums over
    'link'; the 'apa' axis never communicates."""

    def __init__(self, n_apas: int, links_per_apa: int, cfg: TPGConfig,
                 mesh: Optional[LinkMesh] = None,
                 max_hits_per_link: int = 512, backend: str = "scan",
                 time2_feed: bool = False, codec_threads: int = 1):
        from .mesh import make_apa_link_mesh
        self.mesh = mesh or make_apa_link_mesh(n_apas)
        shape = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        if shape.get("apa") != n_apas:
            raise ValueError(
                f"mesh 'apa' axis ({shape.get('apa')}) must equal n_apas "
                f"({n_apas}): each device hosts links of exactly one APA")
        if links_per_apa % shape["link"]:
            raise ValueError("links_per_apa must divide evenly over the "
                             "mesh 'link' axis")
        if time2_feed and backend != "pallas":
            raise ValueError("time2_feed requires backend='pallas'")
        self.cfg = cfg
        self.n_apas = n_apas
        self.links_per_apa = links_per_apa
        self.time2_feed = time2_feed
        # host codec fan-out PER relayout call (A*D calls per batch)
        self.codec_threads = codec_threads
        self._feed_buf = None
        self.step = make_detector_step(
            self.mesh, cfg, max_hits_per_link, backend=backend,
            time2_feed=time2_feed)
        self._stacks = None
        self.dropped_hits = np.zeros(n_apas, dtype=np.int64)  # per APA

    def init_state(self, first_samples: np.ndarray,
                   rs_memory_factor=None) -> None:
        """Seed per-channel state from each APA's first time sample
        ((A, L, 64) array).  ``rs_memory_factor`` is per-APA-shared
        (scalar or (L*64,) — every APA has the same plane geometry)."""
        self._seed(np.reshape(first_samples, (self.n_apas,
                                              self.links_per_apa, N_CH)),
                   rs_memory_factor)

    def host_feed(self, words: np.ndarray):
        """The batch as the step takes it (see ``APAPipeline.host_feed``):
        with time2_feed (A, D, T//2, S_loc, 128) feeds."""
        if not self.time2_feed:
            return words
        A, L = self.n_apas, self.links_per_apa
        D = self.mesh.shape["link"]
        Lloc = L // D
        T = words.shape[2]
        if self._feed_buf is None:
            self._feed_buf = native.FeedBuffer()
        feeds = self._feed_buf.get(
            (A, D) + native.time2_feed_shape(Lloc, T, pad8=False))
        for a in range(A):
            for d in range(D):
                native.relayout_time2(
                    np.ascontiguousarray(words[a, d * Lloc:(d + 1) * Lloc]),
                    out=feeds[a, d], nthreads=self.codec_threads,
                    pad8=False)
        return feeds

    def process(self, words: np.ndarray):
        """words: (A, L, T, 28) uint32 packed ADC rows, one row block per
        (apa, link).  Returns (hits (A, L, max_hits, 6), n_hits (A, L),
        apa_totals (A,) int64)."""
        A, L = self.n_apas, self.links_per_apa
        if tuple(words.shape[:2]) != (A, L):
            raise ValueError(f"expected ({A}, {L}, T, 28) words, got "
                             f"{tuple(words.shape)}")
        if self._stacks is None:
            adcs0 = unpack_14bit(
                np.asarray(words[:, :, 0]).reshape(A * L, -1),
                N_CH).astype(np.int32)
            self.init_state(adcs0.reshape(A, L, N_CH))
        hits, n_hits, totals, dropped, self._stacks = self.step.run(
            self.host_feed(words), self._stacks)
        counts = torch.stack([totals, dropped]).cpu().numpy()
        self.dropped_hits += counts[1]
        return hits, n_hits, counts[0]
