"""Channel map service (≈ detchannelmaps::TPCChannelMap).

Copied from ``fdreadoutlibs_tpu/utils/channel_map.py:20-576``: the maps
the port's processors resolve through :func:`make_map` (the vertical-drift
:class:`VDTDEChannelMap` among them), and the tools of the fidelity
harness that the CLI's ``channel-map --write-dump`` and ``validate-map``
call (:func:`cross_check_maps`, :func:`write_detchannelmaps_dump`) and
:func:`register_map_via_expansion`; the code is unchanged.

The reference resolves (crate, slot, stream, in-frame channel) -> offline
channel and offline channel -> plane through an external package
(RegisterToChannelNumber.cpp:49-50, WIBEthFrameProcessor.cpp:443).  Here the
service is a pluggable registry; the built-in maps cover the shapes the
SWTPG path needs:

* ``IdentityChannelMap`` — offline = stream-linear offset + channel;
  plane split configurable per link (first ``n_collection`` channels are
  collection, matching the WIBEth half-FEMB layout where a 64-channel
  stream carries one plane's worth of wires split 40/24 or similar);
* ``PermutedChannelMap`` — same but with an arbitrary per-link permutation
  (exercises the register-order bookkeeping in tests).

detchannelmaps' production maps (VDColdbox etc.) are lookup tables; any
table can be loaded via ``TableChannelMap``.
"""

from __future__ import annotations

import os

import numpy as np

_REGISTRY = {}

#: Checked-in full-APA channel-map dump (detchannelmaps text format) that is
#: the production default for HDAPAChannelMap.  Provenance: generated by
#: ``write_detchannelmaps_dump`` from the geometry derivation documented on
#: HDAPAChannelMap and pinned by tests/test_channel_map.py — see the file
#: header and PARITY.md ("Channel map provenance").  When a dump generated by
#: the real upstream ``detchannelmaps`` package is available, replace this
#: file (same format) and the whole framework follows.
PACKAGED_DUMP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "data", "PD2HD_APA_wibeth.txt")


class ChannelMap:
    """Interface mirroring the used subset of TPCChannelMap."""

    def get_offline_channel_from_crate_slot_stream_chan(
            self, crate: int, slot: int, stream: int, chan: int) -> int:
        raise NotImplementedError

    def get_plane_from_offline_channel(self, offline: int) -> int:
        """0 = collection (the reference's convention,
        WIBEthFrameProcessor.cpp:443), nonzero = induction."""
        raise NotImplementedError

    # vectorized conveniences
    def offline_channels(self, crate: int, slot: int, stream: int,
                         n_channels: int) -> np.ndarray:
        return np.array([
            self.get_offline_channel_from_crate_slot_stream_chan(
                crate, slot, stream, c) for c in range(n_channels)],
            dtype=np.int64)

    def planes(self, offline: np.ndarray) -> np.ndarray:
        return np.array([self.get_plane_from_offline_channel(int(c))
                         for c in np.asarray(offline)], dtype=np.int64)


class IdentityChannelMap(ChannelMap):
    """offline = (((crate * n_slots) + slot) * n_streams + stream) * 64 + chan."""

    def __init__(self, channels_per_stream: int = 64, n_slots: int = 8,
                 n_streams: int = 64, n_collection: int = 0):
        self.channels_per_stream = channels_per_stream
        self.n_slots = n_slots
        self.n_streams = n_streams
        self.n_collection = n_collection  # per-stream leading collection chans

    def get_offline_channel_from_crate_slot_stream_chan(self, crate, slot,
                                                        stream, chan):
        link = (crate * self.n_slots + slot) * self.n_streams + stream
        return link * self.channels_per_stream + chan

    def get_plane_from_offline_channel(self, offline):
        in_stream = offline % self.channels_per_stream
        return 0 if in_stream < self.n_collection else 2


class PermutedChannelMap(IdentityChannelMap):
    """Identity map composed with a fixed per-stream channel permutation."""

    def __init__(self, permutation, **kw):
        super().__init__(**kw)
        self.permutation = np.asarray(permutation)
        assert len(self.permutation) == self.channels_per_stream

    def get_offline_channel_from_crate_slot_stream_chan(self, crate, slot,
                                                        stream, chan):
        link = (crate * self.n_slots + slot) * self.n_streams + stream
        return link * self.channels_per_stream + int(self.permutation[chan])


class TableChannelMap(ChannelMap):
    """Arbitrary lookup-table map: {(crate, slot, stream): offline[64]} plus
    an offline->plane table."""

    def __init__(self, table: dict, plane_table: dict):
        self.table = {k: np.asarray(v) for k, v in table.items()}
        self.plane_table = plane_table

    def get_offline_channel_from_crate_slot_stream_chan(self, crate, slot,
                                                        stream, chan):
        return int(self.table[(crate, slot, stream)][chan])

    def get_plane_from_offline_channel(self, offline):
        return self.plane_table[int(offline)]

    # DUNE offline files use plane 0=U, 1=V, 2=collection; this framework
    # follows the reference SWTPG convention 0=collection (module
    # docstring; WIBEthFrameProcessor.cpp:443 tests `plane == 0` for
    # collection), so file planes are translated on load.
    _DUNE_PLANE_TO_NATIVE = {0: 1, 1: 2, 2: 0}

    @classmethod
    def from_file(cls, path, channels_per_stream: int = 64,
                  plane_convention: str = "detchannelmaps"):
        """Load a detchannelmaps-style whitespace table.

        Expected columns per row (the layout of detchannelmaps' HD map
        text files, e.g. PD2HDChannelMap_v*.txt):
        ``offline_channel crate slot stream stream_channel plane``
        (lines starting with '#' are comments).

        plane_convention: "detchannelmaps" (default — file planes are the
        DUNE offline 0=U/1=V/2=collection and get translated to this
        framework's 0=collection convention) or "native" (file planes are
        already in the framework convention).
        """
        assert plane_convention in ("detchannelmaps", "native")
        translate = cls._DUNE_PLANE_TO_NATIVE if \
            plane_convention == "detchannelmaps" else {}
        table: dict = {}
        plane_table: dict = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                offline, crate, slot, stream, ch, plane = \
                    (int(v) for v in line.split()[:6])
                key = (crate, slot, stream)
                if key not in table:
                    table[key] = np.full(channels_per_stream, -1,
                                         dtype=np.int64)
                table[key][ch] = offline
                plane_table[offline] = translate.get(plane, plane)
        return cls(table, plane_table)


# ---- DUNE horizontal-drift APA map (geometry-derived) -----------------------

class HDAPAChannelMap(ChannelMap):
    """DUNE HD APA channel map, derived from the documented APA geometry.

    The reference resolves this through the external ``detchannelmaps``
    package (``PD2HDChannelMap``; RegisterToChannelNumber.cpp:49-50); its
    lookup tables are not part of the fdreadoutlibs repo, so this rebuild
    derives the map from the public APA electronics geometry:

    * one APA = 2560 channels: 800 U + 800 V + 960 X (collection), read
      out by 20 FEMBs of 128 channels (40 U + 40 V + 48 X each);
    * WIBEth readout (``frontend="wibeth"``, default): crate = APA, slot =
      WIB in [0, 5), stream in [0, 8) = (FEMB-in-WIB in [0,4)) * 2 + half,
      each stream one 64-channel half-FEMB (DUNEWIBEthTypeAdapter
      s_channels_per_half_femb = 64);
    * WIB2 readout (``frontend="wib2"``): the DUNE-WIB serves the same 4
      FEMBs over 2 links of 256 channels (DUNEWIBSuperChunkTypeAdapter;
      the reference processes each link as two 128-channel register-
      selector halves, WIB2FrameProcessor.cpp:224-225) — stream = link in
      [0, 2), chan in [0, 256): femb = slot*4 + link*2 + chan//128,
      in-FEMB channel = chan % 128;
    * offline numbering is electronics-ordered within each plane block
      (the detchannelmaps convention):
      ``offline = apa*2560 + plane_offset + femb*per_femb + index`` with
      plane offsets U=0, V=800, X=1600;
    * the in-FEMB channel -> (plane, index) assignment is a 128-entry
      data table (``femb_table``).  The production default
      (``femb_table=None``) is loaded from the checked-in dump file
      ``PACKAGED_DUMP`` (data/PD2HD_APA_wibeth.txt) so the deployed
      wiring is a data file, not code: replace that file with a dump
      generated by upstream detchannelmaps and every consumer follows.
      ``femb_table="geometry"`` selects the derived block layout
      [40 U | 40 V | 48 X] directly (currently identical to the packaged
      dump — see PARITY.md "Channel map provenance"); an explicit
      (128, 2) array injects any table, and a full file map can be
      loaded via :meth:`TableChannelMap.from_file` — every consumer only
      depends on the ChannelMap interface.

    Planes follow this framework's convention (module docstring):
    0 = collection (X), 1 = induction U, 2 = induction V.
    """

    CHANNELS_PER_APA = 2560
    N_WIBS = 5                    # slots per APA
    N_STREAMS = 8                 # half-FEMBs per WIB
    FEMB_CHANNELS = 128
    PLANE_SIZES = {1: 40, 2: 40, 0: 48}          # per FEMB: U, V, X
    PLANE_OFFSETS = {1: 0, 2: 800, 0: 1600}      # per APA plane blocks
    N_FEMBS = 20

    def __init__(self, femb_table=None, frontend: str = "wibeth"):
        if frontend not in ("wibeth", "wib2"):
            raise ValueError(f"unknown frontend {frontend!r} "
                             "(expected 'wibeth' or 'wib2')")
        self.frontend = frontend
        if femb_table is None:
            # production default: the checked-in dump file (PACKAGED_DUMP),
            # so swapping in a real detchannelmaps dump is a one-file change
            femb_table = packaged_femb_table()
        elif isinstance(femb_table, str):
            if femb_table == "geometry":
                femb_table = self.default_femb_table()
            else:
                raise ValueError(
                    f"femb_table must be a (128, 2) array, None (packaged "
                    f"dump) or 'geometry'; got {femb_table!r}")
        femb_table = np.asarray(femb_table)
        assert femb_table.shape == (self.FEMB_CHANNELS, 2)
        self.femb_table = femb_table
        # per-APA offline layout is identical for every APA; precompute the
        # in-APA offline number for (femb, femb_chan)
        plane = femb_table[:, 0]
        idx = femb_table[:, 1]
        per_femb = np.array([self.PLANE_SIZES[int(p)] for p in plane])
        off = np.array([self.PLANE_OFFSETS[int(p)] for p in plane])
        fembs = np.arange(self.N_FEMBS)
        # (femb, femb_chan) -> offline-within-APA
        self._in_apa = (off[None, :] + fembs[:, None] * per_femb[None, :]
                        + idx[None, :])

    @classmethod
    def default_femb_table(cls) -> np.ndarray:
        """(128, 2) [plane, plane-local index] per FEMB channel: block
        layout [40 U | 40 V | 48 X]."""
        plane = np.concatenate([np.full(40, 1), np.full(40, 2),
                                np.full(48, 0)])
        idx = np.concatenate([np.arange(40), np.arange(40), np.arange(48)])
        return np.stack([plane, idx], axis=1)

    def _femb_coords(self, slot: int, stream: int, chan: int):
        """(slot, stream, in-stream channel) -> (femb, in-FEMB channel) per
        the configured frontend geometry (class docstring)."""
        assert 0 <= slot < self.N_WIBS
        if self.frontend == "wib2":
            if not (0 <= stream < 2 and 0 <= chan < 256):
                raise ValueError(
                    f"WIB2 geometry: link in [0,2), chan in [0,256); got "
                    f"stream={stream}, chan={chan}")
            return slot * 4 + stream * 2 + chan // 128, chan % 128
        if not (0 <= stream < self.N_STREAMS and 0 <= chan < 64):
            raise ValueError(
                f"WIBEth geometry: stream in [0,8), chan in [0,64) "
                f"(half-FEMB streams); got stream={stream}, chan={chan}.  "
                "256-channel WIB2 frontends use "
                "HDAPAChannelMap(frontend='wib2').")
        return slot * 4 + stream // 2, (stream % 2) * 64 + chan

    def get_offline_channel_from_crate_slot_stream_chan(self, crate, slot,
                                                        stream, chan):
        femb, femb_chan = self._femb_coords(slot, stream, chan)
        return int(crate) * self.CHANNELS_PER_APA + \
            int(self._in_apa[femb, femb_chan])

    def get_plane_from_offline_channel(self, offline):
        in_apa = int(offline) % self.CHANNELS_PER_APA
        if in_apa >= 1600:
            return 0          # collection (X)
        return 1 if in_apa < 800 else 2   # U, V

    # vectorized fast path (the per-link setup in apps uses this)
    def offline_channels(self, crate, slot, stream, n_channels=64):
        stream_width = 256 if self.frontend == "wib2" else 64
        if n_channels > stream_width:
            raise ValueError(
                f"HDAPAChannelMap({self.frontend!r}) streams carry "
                f"{stream_width} channels; asked for {n_channels}.")
        if self.frontend == "wib2":
            assert 0 <= slot < self.N_WIBS and 0 <= stream < 2
            fembs = slot * 4 + stream * 2 + np.arange(n_channels) // 128
            chans = np.arange(n_channels) % 128
            in_apa = self._in_apa[fembs, chans]
        else:
            femb = slot * 4 + stream // 2
            base = (stream % 2) * 64
            in_apa = self._in_apa[femb, base:base + n_channels]
        return (crate * self.CHANNELS_PER_APA + in_apa).astype(np.int64)


class VDTDEChannelMap(ChannelMap):
    """Vertical-drift top-electronics (TDE) channel map, geometry-derived.

    The VD top drift is read out by uTCA crates of AMC digitizer cards,
    64 channels each (TDE16 frames; TDEFrameTypeAdapter); one CRP
    (charge-readout plane) carries 3072 strips in three views —
    induction-1, induction-2, collection, sizes (952, 952, 1168).  The
    reference has no VD map in-repo either (it would come from
    detchannelmaps' vdcb/vdtop tables), so, like :class:`HDAPAChannelMap`,
    this derives offline numbers from the electronics geometry and takes
    the exact installation orderings as injectable data:

    * ``offline = crp * 3072 + serial`` with
      ``serial = perm[((crate % crates_per_crp) * n_slots + slot) * 64
      + chan]`` and ``crp = crate // crates_per_crp``;
    * ``perm`` is an optional 3072-entry permutation (identity by
      default) — inject the real vdtop ordering here, or load a full
      dump via :meth:`TableChannelMap.from_file`;
    * planes follow this framework's convention: 0 = collection,
      1/2 = induction views, split by cumulative view sizes.
    """

    def __init__(self, plane_sizes=(952, 952, 1168), crates_per_crp: int = 4,
                 n_slots: int = 12, permutation=None):
        self.plane_sizes = tuple(int(s) for s in plane_sizes)
        self.channels_per_crp = sum(self.plane_sizes)
        self.crates_per_crp = crates_per_crp
        self.n_slots = n_slots
        if crates_per_crp * n_slots * 64 != self.channels_per_crp:
            raise ValueError(
                f"geometry mismatch: {crates_per_crp} crates x {n_slots} "
                f"AMCs x 64 != {self.channels_per_crp} channels/CRP")
        if permutation is None:
            self.permutation = np.arange(self.channels_per_crp)
        else:
            self.permutation = np.asarray(permutation)
            if sorted(self.permutation.tolist()) != \
                    list(range(self.channels_per_crp)):
                raise ValueError("permutation must be a permutation of "
                                 f"range({self.channels_per_crp})")

    def get_offline_channel_from_crate_slot_stream_chan(self, crate, slot,
                                                        stream, chan):
        # TDE links carry one stream per AMC; ``stream`` is the link id
        # and is 0 in the tde_file_creator layout — fold it into the slot
        # index if an installation uses multiple links per AMC
        if not (0 <= slot < self.n_slots and 0 <= chan < 64):
            raise ValueError(f"TDE geometry: slot in [0,{self.n_slots}), "
                             f"chan in [0,64); got {slot}, {chan}")
        crp, crate_in = divmod(int(crate), self.crates_per_crp)
        serial = (crate_in * self.n_slots + int(slot)) * 64 + int(chan)
        return crp * self.channels_per_crp + int(self.permutation[serial])

    def get_plane_from_offline_channel(self, offline):
        in_crp = int(offline) % self.channels_per_crp
        u, v, _ = self.plane_sizes
        if in_crp < u:
            return 1
        if in_crp < u + v:
            return 2
        return 0                                      # collection

    def offline_channels(self, crate, slot, stream, n_channels=64):
        # same geometry validation as the scalar accessor — this is the
        # path TDEFrameProcessor uses, and an out-of-range slot would
        # otherwise alias into another AMC's serial range silently
        if not (0 <= int(slot) < self.n_slots and 0 < n_channels <= 64):
            raise ValueError(f"TDE geometry: slot in [0,{self.n_slots}), "
                             f"n_channels in (0,64]; got {slot}, {n_channels}")
        if int(crate) < 0:
            raise ValueError(f"TDE geometry: crate must be >= 0; got {crate}")
        crp, crate_in = divmod(int(crate), self.crates_per_crp)
        base = (crate_in * self.n_slots + int(slot)) * 64
        serial = base + np.arange(n_channels)
        return (crp * self.channels_per_crp
                + self.permutation[serial]).astype(np.int64)


# ---- fidelity harness: dump-file cross-checks --------------------------------

def cross_check_maps(map_a: ChannelMap, map_b: ChannelMap, keys,
                     n_channels: int = 64, max_report: int = 20) -> dict:
    """Compare two maps over (crate, slot, stream) keys; report exact
    divergences.  This is the validation harness for detchannelmaps dump
    files (VERDICT r2 #5): load the dump with TableChannelMap.from_file
    and cross-check it against the geometry-derived map — equality
    confirms the derivation; the mismatch list pins the exact divergence
    otherwise.
    """
    n_checked = n_off = n_plane = 0
    mismatches = []
    for crate, slot, stream in keys:
        off_a = map_a.offline_channels(crate, slot, stream, n_channels)
        off_b = map_b.offline_channels(crate, slot, stream, n_channels)
        bad = np.nonzero(off_a != off_b)[0]
        n_checked += n_channels
        n_off += len(bad)
        for c in bad[:max(0, max_report - len(mismatches))]:
            mismatches.append({"crate": crate, "slot": slot,
                               "stream": stream, "chan": int(c),
                               "offline_a": int(off_a[c]),
                               "offline_b": int(off_b[c])})
        agree = off_a[off_a == off_b]
        n_plane += int(np.sum(map_a.planes(agree) != map_b.planes(agree)))
    return {"n_checked": n_checked, "n_offline_mismatch": n_off,
            "n_plane_mismatch": n_plane, "match": n_off + n_plane == 0,
            "mismatches": mismatches}


def frontend_geometry(frontend: str) -> tuple[int, int]:
    """(n_streams, channels_per_stream) for an HD-APA frontend.

    The ONE place the WIBEth-vs-WIB2 link shape lives — dump parsing
    (femb_table_from_dump), the validate-map CLI cross-check, and any
    future frontend all resolve through here so they cannot disagree.
    """
    if frontend == "wib2":
        return 2, 256
    if frontend == "wibeth":
        return HDAPAChannelMap.N_STREAMS, 64
    raise ValueError(f"unknown frontend {frontend!r} "
                     "(expected 'wibeth' or 'wib2')")


def femb_table_from_dump(path: str, crate: int = 0,
                         frontend: str = "wibeth") -> np.ndarray:
    """Derive HDAPAChannelMap's (128, 2) femb_table from a detchannelmaps
    dump file, making the geometry map production-exact.

    Requires the dump to fit the per-FEMB parametrization
    (offline = apa*2560 + plane_offset + femb*per_femb + index, class
    docstring); raises ValueError naming the first violation otherwise —
    in that case use TableChannelMap.from_file directly (exact for any
    layout).
    """
    n_streams, width = frontend_geometry(frontend)
    tbl = TableChannelMap.from_file(path, channels_per_stream=width)
    # "geometry" femb_table: only _femb_coords is used here (frontend link
    # shape), which is independent of the table — and the packaged-dump
    # default would recurse through this very function
    geo = HDAPAChannelMap(femb_table="geometry", frontend=frontend)
    sizes = HDAPAChannelMap.PLANE_SIZES
    offsets = HDAPAChannelMap.PLANE_OFFSETS
    femb_table = np.full((HDAPAChannelMap.FEMB_CHANNELS, 2), -1,
                         dtype=np.int64)
    for slot in range(HDAPAChannelMap.N_WIBS):
        for stream in range(n_streams):
            try:
                offline = tbl.offline_channels(crate, slot, stream, width)
            except KeyError:
                continue
            for chan, off in enumerate(offline.tolist()):
                femb, femb_chan = geo._femb_coords(slot, stream, chan)
                in_apa = off - crate * HDAPAChannelMap.CHANNELS_PER_APA
                if not 0 <= in_apa < HDAPAChannelMap.CHANNELS_PER_APA:
                    raise ValueError(
                        f"offline channel {off} at crate={crate} "
                        f"slot={slot} stream={stream} chan={chan} is "
                        f"outside crate {crate}'s APA range — wrong "
                        f"--crate, or the dump does not fit the per-FEMB "
                        f"parametrization; use TableChannelMap.from_file")
                plane = next((p for p, o in sorted(offsets.items(),
                                                   key=lambda kv: -kv[1])
                              if in_apa >= o), None)
                idx = in_apa - offsets[plane] - femb * sizes[plane]
                if not 0 <= idx < sizes[plane]:
                    raise ValueError(
                        f"dump does not fit the per-FEMB parametrization "
                        f"at crate={crate} slot={slot} stream={stream} "
                        f"chan={chan}: offline {off} -> femb {femb} "
                        f"plane {plane} index {idx} (expected 0 <= idx < "
                        f"{sizes[plane]}); use TableChannelMap.from_file")
                prev = femb_table[femb_chan]
                if prev[0] != -1 and (prev[0] != plane or prev[1] != idx):
                    raise ValueError(
                        f"dump is not FEMB-uniform: FEMB channel "
                        f"{femb_chan} maps to {tuple(prev)} and "
                        f"({plane}, {idx}) on different FEMBs; use "
                        f"TableChannelMap.from_file")
                femb_table[femb_chan] = (plane, idx)
    if (femb_table[:, 0] == -1).any():
        missing = int(np.sum(femb_table[:, 0] == -1))
        raise ValueError(f"dump covers only {128 - missing}/128 FEMB "
                         f"channels for crate {crate}")
    return femb_table


_PACKAGED_FEMB_CACHE: dict = {}


def packaged_femb_table(path: str | None = None) -> np.ndarray:
    """The (128, 2) femb_table derived from the checked-in dump file
    (PACKAGED_DUMP by default), cached per path — HDAPAChannelMap is
    constructed once per link in the apps and the 2560-row parse should
    happen once per process, not 40 times."""
    key = os.path.abspath(path or PACKAGED_DUMP)
    if key not in _PACKAGED_FEMB_CACHE:
        _PACKAGED_FEMB_CACHE[key] = femb_table_from_dump(key, crate=0,
                                                         frontend="wibeth")
    return _PACKAGED_FEMB_CACHE[key]


# native plane convention (0=collection, 1=U, 2=V; module docstring) -> the
# DUNE offline file convention (0=U, 1=V, 2=collection) used in dump files;
# inverse of TableChannelMap._DUNE_PLANE_TO_NATIVE
_NATIVE_PLANE_TO_DUNE = {1: 0, 2: 1, 0: 2}


def write_detchannelmaps_dump(ch_map: ChannelMap, path: str, crate: int = 0,
                              frontend: str = "wibeth",
                              header: str = "") -> int:
    """Write one crate's map as a detchannelmaps-style text dump
    (``offline crate slot stream stream_channel plane``, DUNE offline plane
    convention — the exact format TableChannelMap.from_file reads back).
    Returns the number of rows written."""
    n_streams, width = frontend_geometry(frontend)
    rows = 0
    with open(path, "w") as f:
        for line in header.splitlines():
            f.write(f"# {line}\n" if line else "#\n")
        f.write("# columns: offline crate slot stream stream_channel "
                "plane(0=U 1=V 2=collection)\n")
        for slot in range(HDAPAChannelMap.N_WIBS):
            for stream in range(n_streams):
                offline = ch_map.offline_channels(crate, slot, stream, width)
                planes = ch_map.planes(offline)
                for chan in range(width):
                    f.write(f"{int(offline[chan])} {crate} {slot} {stream} "
                            f"{chan} {_NATIVE_PLANE_TO_DUNE[int(planes[chan])]}\n")
                    rows += 1
    return rows


def register_map(name: str, factory) -> None:
    _REGISTRY[name] = factory


def make_map(name: str, **kw) -> ChannelMap:
    """detchannelmaps::make_map equivalent."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown channel map '{name}' "
                       f"(available: {sorted(_REGISTRY)})")
    return _REGISTRY[name](**kw)


def register_map_via_expansion(ch_map: ChannelMap, crate: int, slot: int,
                               stream: int, n_channels: int = 64,
                               unpack=None, pack=None) -> np.ndarray:
    """The reference's RegisterToChannelNumber trick as a pure computation
    (src/wibeth/tpg/RegisterToChannelNumber.cpp:35-122): write each frame
    channel's offline number (minus the minimum) as its ADC value, push the
    frame through the *real* unpack, and read back where each channel
    landed.  With this framework's natural-order unpack the result is the
    direct offline map; pass pack/unpack callables to audit any other
    layout (e.g. the register-order views).
    Returns offline channel per unpacked position.
    """
    offline = ch_map.offline_channels(crate, slot, stream, n_channels)
    min_ch = int(offline.min())
    values = (offline - min_ch).astype(np.uint16)
    if pack is None or unpack is None:
        from ..formats import wibeth as _w
        frames = _w.empty_frames(1)
        _w.set_adcs(frames, np.broadcast_to(values, (1, 64, 64)).copy())
        landed = _w.get_adcs(frames)[0, 0]
    else:
        landed = unpack(pack(values))
    return np.asarray(landed, dtype=np.int64) + min_ch


register_map("IdentityChannelMap", IdentityChannelMap)
register_map("PermutedChannelMap", PermutedChannelMap)
register_map("HDAPAChannelMap", HDAPAChannelMap)
# Name-compatible aliases for configs written against detchannelmaps: the
# HD names resolve to the geometry-derived APA map (HDAPAChannelMap docs);
# the vertical-drift name stays identity-linear unless a table is loaded.
register_map("PD2HDChannelMap", HDAPAChannelMap)
register_map("HDColdboxChannelMap", HDAPAChannelMap)
register_map("VDColdboxChannelMap", IdentityChannelMap)
register_map("ProtoDUNESP1ChannelMap", HDAPAChannelMap)
# vertical-drift top electronics (the TDE path)
register_map("VDTDEChannelMap", VDTDEChannelMap)
register_map("VDTopChannelMap", VDTDEChannelMap)
