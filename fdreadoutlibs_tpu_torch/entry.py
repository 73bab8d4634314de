"""Entry points of the port: one forward step of the flagship pipeline, and
the multi-device dry run.

``entry()`` is the counterpart of ``__graft_entry__.py::entry()``
(:14-43): WIBEth packed
frame words -> 14-bit unpack -> frugal pedestal -> threshold hit finding ->
device-side hit compaction, with the same inputs (T = 64 ticks of one
link's frame words, a seeded state, one injected pulse) and threshold.

On a CUDA device ``fn`` launches K4 (``ops.ingest.process_packed_frames_
fused``: the unpack inside the kernel) with tc = 64 and 32 slots a channel,
room for every close in 64 ticks (a channel closes at most every second
tick), so it drops nothing, as the JAX entry's dense scan drops nothing;
then ``ops.ingest.compact_on_device`` at ``max_hits`` = 256.  On
``device="cpu"`` it runs K4's plain version.

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.py::dryrun_multichip`` (:45-264): every part of the JAX
function, on an n-shard mesh of the port (``parallel/``).  The JAX one
pins itself to the virtual CPU device pool; this one runs on the card
(n shards on ``cuda:0`` unless n cards are visible) unless it is given
``device="cpu"``, where every shard runs the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import wibeth
from .ops import TPGConfig, init_chanstate, seed_chanstate
from .ops.ingest import compact_on_device, process_packed_frames_fused
from .ops.tpg import pack_state

T = 64
TC = 64
K_SLOTS = 32
MAX_HITS = 256
CFG = TPGConfig(threshold=150)


def forward(words: torch.Tensor, state: torch.Tensor):
    """words: (T, 28) int32 packed WIBEth ADC rows (the bits of the frame's
    uint32 words); state: (KSTATE, 64) from ``ops.tpg.pack_state``.

    Returns (hits (MAX_HITS, 6) int32 [channel, end_tick, charge, tover,
    peak_adc, peak_time] in canonical order, n_hits as a 0-d tensor,
    new_state), all on the inputs' device."""
    C = wibeth.N_CHANNELS
    slots, nclose, new_state = process_packed_frames_fused(
        words[None], state, CFG, C, tc=TC, k_slots=K_SLOTS)
    packed = compact_on_device(slots, nclose, 0, C, MAX_HITS)
    return packed[:MAX_HITS], packed[MAX_HITS, 0], new_state


def entry(device=None):
    """Return (fn, example_args): the forward step and its inputs on
    ``device`` (None -> "cuda", which raises without a card)."""
    from .apps.apa_readout import resolve_device
    dev = resolve_device("cuda" if device is None else device)
    rng = np.random.default_rng(0)
    frames = wibeth.empty_frames(1)
    adcs = (900 + rng.normal(0, 30, size=(1, T, 64))).astype(np.uint16)
    adcs[0, 20:25, 7] += 2000
    wibeth.set_adcs(frames, adcs)
    words = torch.from_numpy(
        wibeth.frames_bytes_to_u32(frames)[0].view(np.int32)).to(dev)
    C = wibeth.N_CHANNELS
    state = pack_state(seed_chanstate(init_chanstate(C),
                                      adcs[0, 0].astype(np.int32), 8),
                       C, device=dev)
    return forward, (words, state)


def _dryrun_words(n_links: int, T: int, rng, pulse) -> np.ndarray:
    """(n_links, T, 28) uint32 frame words of noise drawn from ``rng`` with
    one pulse a link: ``pulse(adcs, link)`` adds it to the link's (frames,
    64, 64) ADCs."""
    words = np.zeros((n_links, T, 28), dtype=np.uint32)
    for link in range(n_links):
        frames = wibeth.empty_frames(T // wibeth.N_TIME_SAMPLES)
        adcs = (800 + rng.normal(0, 25, size=(T // wibeth.N_TIME_SAMPLES,
                                              64, 64))).astype(np.uint16)
        pulse(adcs, link)
        wibeth.set_adcs(frames, adcs)
        words[link] = wibeth.frames_bytes_to_u32(frames).reshape(T, 28)
    return words


def _composition_app(device) -> dict:
    """The full-detector app (TPC, PDS and TDE arms sharing the request and
    fragment layer), one tiny batch an arm, pipelined (:209-255).  Returns
    its ``get_info()``."""
    from .apps.detector_readout import DetectorReadoutApp, TPC_SOURCE_BASE
    from .formats import daphne
    from .formats import tde as tde_fmt
    app = DetectorReadoutApp(apa_links=2, pds_links=1, tde_links=1,
                             tpc_threshold=499, tde_backend="reference",
                             pipelined=True, device=device)
    frames = wibeth.empty_frames(2).reshape(2, 1, -1)
    adcs = np.full((2, 1, 64, 64), 800, np.uint16)
    adcs[1, 0, 10:18, 5] += np.uint16(700)
    for link in range(2):
        wibeth.set_adcs(frames[link], adcs[link])
        wibeth.fake_timestamps(frames[link], 0x100000)
        wibeth.fake_seq_ids(frames[link], 0)
        wibeth.fake_geoid(frames[link], 1, link // 8, link % 8)
    app.process_tpc_batch(frames)
    scs = daphne.empty_superchunks(2, stream=True)[None]
    # a real PDS pulse so the arm's hit count is assertable
    pframes = daphne.superchunk_frames(scs[0], stream=True) \
        .reshape(-1, daphne.STREAM_FRAME_SIZE)
    Tp = daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
    padcs = np.full((2 * Tp, 4), 700, np.uint16).reshape(
        -1, daphne.STREAM_N_SAMPLES, 4)
    padcs.reshape(2, Tp, 4)[1, 40:50, 2] += np.uint16(900)
    daphne.stream_set_adcs(pframes, padcs)
    daphne.fake_timestamps(scs[0], 0x200000, offset=64, stream=True)
    app.process_pds_batch(scs)
    C, S = tde_fmt.N_CHANNELS_PER_LINK, tde_fmt.TOT_ADC16_SAMPLES
    tf = tde_fmt.empty_frames(C)[None]
    tde_fmt.set_channel(tf[0], np.arange(C))
    tde_fmt.set_timestamp(tf[0], np.full(C, 0x300000, dtype=np.uint64))
    samples = np.full((C, S), 8000, np.uint16)
    samples[9, 500:512] += np.uint16(2500)
    tde_fmt.set_adc_samples(tf[0], samples)
    app.process_tde_batch(tf)
    app.flush()
    info = app.get_info()
    assert info["tpc"]["total_hits"] == 1, info["tpc"]
    assert info["pds"]["total_hits"] >= 1, info["pds"]
    assert info["tde"]["total_hits"] == 1, info["tde"]
    assert len(app.request_raw(TPC_SOURCE_BASE + 1, 0x100000,
                               0x100000 + 2048)) >= 1
    return info


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded streaming step over an n-shard mesh, with the JAX
    dry run's every check (:45-264): the scan step twice carrying state;
    the pallas backend on a 2-shard sub-mesh in its three ingests (the
    same total); a 40-link APA (5 links a shard on 8) with a sharded
    checkpoint, a bit-exact resume and fault isolation (garbage words on
    link n40 // 2); the ('apa', 'link') detector mesh with per-APA totals;
    the composition app.  Prints one ``dryrun_multichip OK ...`` line.

    ``device``: None runs on the card (n shards on ``cuda:0`` unless n
    cards are visible; raises without one), ``"cpu"`` the plain versions."""
    import tempfile
    from .apps.apa_readout import resolve_device
    from .ops import Algorithm
    from .parallel import (APAPipeline, DetectorPipeline, make_apa_link_mesh,
                           make_link_mesh)
    from .utils.checkpoint import load_sharded_state, save_sharded_state

    dev = resolve_device("cuda" if device is None else device)
    if device is None and torch.cuda.device_count() >= n_devices:
        on = None                    # one shard a card
    else:
        on = dev if dev.type == "cpu" or dev.index is not None \
            else torch.device("cuda", 0)
    mesh = make_link_mesh(n_devices, device=on)
    n_links = 2 * n_devices                  # 2 WIBEth streams per shard
    cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=120)
    pipe = APAPipeline(n_links, cfg, mesh=mesh)

    # two frames (128 ticks) of noise + one pulse per link
    T = 2 * wibeth.N_TIME_SAMPLES

    def pulse(adcs, link):
        adcs[1, 10:16, link % 64] += 3000

    words = _dryrun_words(n_links, T, np.random.default_rng(1), pulse)
    hits, n_hits, total = pipe.process(words)
    assert hits.shape[0] == n_links
    assert int(total) == int(np.asarray(n_hits).sum())
    # state must carry: a second step reuses the split carry
    hits2, n2, total2 = pipe.process(words)
    assert hits2.shape[0] == n_links

    # the production (pallas) backend on a small sub-mesh, in its three
    # ingests: canonical device unpack, fused in-kernel unpack and the
    # time2 host feed — they must agree hit for hit
    sub = min(2, n_devices)
    totals = {}
    for name, kw in (("pallas", {}), ("fused", {"fused_unpack": True}),
                     ("time2", {"time2_feed": True})):
        p = APAPipeline(sub * 2, TPGConfig(threshold=120),
                        mesh=make_link_mesh(sub, device=mesh.devices[0]),
                        backend="pallas", **kw)
        _, n_p, totals[name] = p.process(words[: sub * 2])
        assert int(totals[name]) == int(np.asarray(n_p).sum())
        assert totals[name] == totals["pallas"], totals

    # ---- production-shape APA: 40 links split over the full mesh ----
    # 5 links (320 channels) a shard on 8 shards, the shape production
    # deploys: (a) the step runs and carries state, (b) a sharded
    # checkpoint resumes bit-exactly mid-stream, (c) corrupt bytes on one
    # link perturb no other link's hits or carried state
    n40 = 5 * n_devices
    cfg40 = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=120)

    def pulse40(adcs, link):
        adcs[1, 8:14, (3 * link) % 64] += 2800

    def gen_words(seed, corrupt_link=None):
        rng40 = np.random.default_rng(seed)
        w = _dryrun_words(n40, T, rng40, pulse40)
        if corrupt_link is not None:
            # garbage ADC payload bytes on ONE link (the frame processors
            # catch header corruption upstream; here the claim is shard
            # isolation of the device hot path itself)
            w[corrupt_link] = rng40.integers(0, 2 ** 32, size=(T, 28),
                                             dtype=np.uint32)
        return w

    def fresh_pipe():
        p = APAPipeline(n40, cfg40, mesh=mesh)
        from .formats.bitpack import unpack_14bit
        p.init_state(unpack_14bit(np.asarray(batch1[:, 0]), 64)
                     .astype(np.int32))
        return p

    batch1, batch2 = gen_words(11), gen_words(12)
    pipe40 = fresh_pipe()
    pipe40.process(batch1)
    with tempfile.TemporaryDirectory() as td:
        save_sharded_state(td + "/apa40_ckpt", pipe40.state)
        hits_a, n_a, tot_a = pipe40.process(batch2)
        # resume: fresh pipeline, restore the sharded checkpoint, replay
        # batch 2 — hits and final state must be bit-exact
        pipe40b = fresh_pipe()
        pipe40b.state = load_sharded_state(td + "/apa40_ckpt",
                                           pipe40b.state)
        hits_b, n_b, tot_b = pipe40b.process(batch2)
    assert tot_a > 0 and tot_b == tot_a, (tot_a, tot_b)
    assert np.array_equal(np.asarray(hits_a), np.asarray(hits_b))
    for k in pipe40.state:
        assert np.array_equal(np.asarray(pipe40.state[k]),
                              np.asarray(pipe40b.state[k])), k
    # fault isolation: corrupt one mid-mesh link in batch 2; every OTHER
    # link's hits and carried state must be untouched
    bad = n40 // 2
    pipe40c = fresh_pipe()
    pipe40c.process(batch1)
    hits_c, n_c, _ = pipe40c.process(gen_words(12, corrupt_link=bad))
    ok_links = [link for link in range(n40) if link != bad]
    assert np.array_equal(np.asarray(n_a)[ok_links],
                          np.asarray(n_c)[ok_links])
    assert np.array_equal(np.asarray(hits_a)[ok_links],
                          np.asarray(hits_c)[ok_links])
    for k in pipe40.state:
        assert np.array_equal(np.asarray(pipe40.state[k])[ok_links],
                              np.asarray(pipe40c.state[k])[ok_links]), k
    apa40_msg = (f"apa40: {n40} links/{n_devices} devices "
                 f"{tot_a} hits, ckpt-resume bit-exact OK, "
                 f"fault-isolation OK (link {bad})")

    # detector-scale 2-D ('apa', 'link') mesh: N independent APAs, each on
    # its own link-axis device group; the sums run over 'link' only, so
    # totals come out per APA
    det_tot = "skipped"
    if n_devices >= 2:
        n_apas = 2
        shards = n_devices // n_apas
        det = DetectorPipeline(
            n_apas, shards * 2, TPGConfig(threshold=120),
            mesh=make_apa_link_mesh(n_apas, shards, device=on))
        det_words = words[: n_apas * shards * 2].reshape(
            n_apas, shards * 2, T, 28)
        _, d_n, d_tot = det.process(det_words)
        assert list(d_tot) == list(np.asarray(d_n).sum(axis=1)), d_tot
        det_tot = "+".join(str(int(t)) for t in d_tot)

    det_info = _composition_app(mesh.devices[0])
    print(f"dryrun_multichip OK: {n_devices} devices, {n_links} links, "
          f"hits step1={total} step2={total2}; pallas backend on {sub} "
          f"devices: {totals['pallas']} hits (fused unpack: "
          f"{totals['fused']}, time2 feed: {totals['time2']}); {apa40_msg}; "
          f"detector 2-D mesh per-APA hits: {det_tot}; composition app "
          f"arms tpc/pds/tde hits: {det_info['tpc']['total_hits']}"
          f"/{det_info['pds']['total_hits']}"
          f"/{det_info['tde']['total_hits']}")
