"""The port's link-axis sharding (``fdreadoutlibs_tpu_torch/parallel/``)
against the JAX package's (``fdreadoutlibs_tpu/parallel/``) on the CPU.

The same words (``make_words`` / ``make_apa_words`` of the JAX tests, numpy
from a seed) go through the JAX ``APAPipeline`` / ``DetectorPipeline`` on
conftest's virtual CPU devices (Pallas in interpret mode) and through the
port's pipelines on ``device="cpu"`` meshes of 1, 2, 4 and 8 shards (the
kernels' plain versions).  Hits (the whole padded array), n_hits, the
total, ``dropped_hits`` and every state key must be equal after each of
two steps: tolerance 0.  The JAX result of each case is computed once and
held against the port at two shard counts; across the cases every ingest
meets every shard count.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fdreadoutlibs_tpu.parallel as jpar
from fdreadoutlibs_tpu.ops import TPGConfig as JaxConfig

from fdreadoutlibs_tpu_torch import parallel
from fdreadoutlibs_tpu_torch.ops import TPGConfig
from fdreadoutlibs_tpu_torch.parallel import (APAPipeline, DetectorPipeline,
                                              make_apa_link_mesh,
                                              make_link_mesh, state_from_jax)
from tests.test_detector_pipeline import make_apa_words
from tests.test_parallel import make_words

torch.set_num_threads(1)

N_LINKS = 8
_FIR = dict(algorithm="FIR", threshold=5)
ALGS = {
    "Simple": dict(algorithm="SimpleThreshold", threshold=120),
    "AbsRS": dict(algorithm="AbsRS", threshold=150),
    "FIR": _FIR,
    "FIR-nopeaks": dict(_FIR, track_peaks=False),
    # noise chatter: closes beyond K per chunk and beyond the per-link
    # bound, so both drop counts are held
    "Simple-chatter": dict(algorithm="SimpleThreshold", threshold=10),
}
INGESTS = {"scan": dict(backend="scan"),
           "pallas": dict(backend="pallas"),
           "fused": dict(backend="pallas", fused_unpack=True),
           "time2": dict(backend="pallas", time2_feed=True)}
# (ingest, algorithm, two shard counts): every ingest meets 1, 2, 4 and 8
CASES = [
    ("scan", "Simple", (1, 8)), ("scan", "AbsRS", (2, 4)),
    ("scan", "FIR", (4, 1)), ("scan", "FIR-nopeaks", (8, 2)),
    ("scan", "Simple-chatter", (2, 8)),
    ("pallas", "Simple", (2, 4)), ("pallas", "AbsRS", (1, 8)),
    ("pallas", "FIR", (8, 2)), ("pallas", "FIR-nopeaks", (4, 1)),
    ("pallas", "Simple-chatter", (8, 1)),
    ("fused", "AbsRS", (1, 2)), ("fused", "FIR", (4, 8)),
    ("time2", "Simple", (2, 1)), ("time2", "FIR-nopeaks", (8, 4)),
]


def configs(alg: str):
    kw = dict(ALGS[alg])
    name = kw.pop("algorithm")
    return JaxConfig.from_raw(name, **kw), TPGConfig.from_raw(name, **kw)


_JAX = {}


def jax_run(ingest: str, alg: str):
    """The JAX pipeline's two steps on the 8-link words, once per case:
    [(hits, n_hits, total, dropped_hits, state)] as numpy."""
    if (ingest, alg) not in _JAX:
        words, _ = make_words(N_LINKS, 2, seed=7)
        kw = dict(INGESTS[ingest])
        if kw["backend"] == "pallas":
            kw["interpret"] = True
        pipe = jpar.APAPipeline(N_LINKS, configs(alg)[0],
                                mesh=jpar.make_link_mesh(2), **kw)
        steps = []
        for _ in range(2):
            hits, n_hits, total = pipe.process(words)
            steps.append((np.asarray(hits), np.asarray(n_hits), total,
                          pipe.dropped_hits,
                          {k: np.asarray(v) for k, v in pipe.state.items()}))
        _JAX[(ingest, alg)] = (words, steps)
    return _JAX[(ingest, alg)]


def assert_step_equal(got, want, label):
    (hits, n_hits, total, dropped, state), \
        (w_hits, w_n, w_total, w_dropped, w_state) = got, want
    np.testing.assert_array_equal(np.asarray(hits), w_hits, err_msg=label)
    np.testing.assert_array_equal(np.asarray(n_hits), w_n, err_msg=label)
    assert int(np.asarray(total).sum()) == int(np.asarray(w_total).sum()), \
        label
    np.testing.assert_array_equal(dropped, w_dropped, err_msg=label)
    assert set(state) == set(w_state), label
    for k in w_state:
        np.testing.assert_array_equal(np.asarray(state[k]), w_state[k],
                                      err_msg=f"{label} {k}")


@pytest.mark.parametrize("ingest,alg,shards", CASES,
                         ids=[f"{i}-{a}" for i, a, _ in CASES])
def test_apa_pipeline_matches_jax(ingest, alg, shards):
    words, want = jax_run(ingest, alg)
    for n in shards:
        pipe = APAPipeline(N_LINKS, configs(alg)[1],
                           mesh=make_link_mesh(n, device="cpu"),
                           **INGESTS[ingest])
        for step, w in enumerate(want):
            hits, n_hits, total = pipe.process(words)
            assert isinstance(total, int)
            assert_step_equal((hits, n_hits, total, pipe.dropped_hits,
                               pipe.state), w, f"{n} shards, step {step}")
    if alg == "Simple-chatter":
        assert want[-1][3] > 0                 # drops were exercised


def test_step_function_matches_jax():
    """``make_apa_step`` as a function of (words, state), as the JAX step
    is called, on a 4-shard mesh: the step's outputs and new state."""
    words, want = jax_run("pallas", "AbsRS")
    mesh = make_link_mesh(4, device="cpu")
    pipe = APAPipeline(N_LINKS, configs("AbsRS")[1], mesh=mesh,
                       backend="pallas")
    pipe.process(words)
    step = parallel.make_apa_step(mesh, configs("AbsRS")[1],
                                  backend="pallas")
    hits, n_hits, total, dropped, state = step(words, pipe.state)
    assert isinstance(hits, parallel.Sharded) and hits.shape == (8, 512, 6)
    assert total.dim() == 0 and dropped.dim() == 0
    assert_step_equal((hits, n_hits, total, want[0][3] + int(dropped),
                       state), want[1], "make_apa_step")


def test_resume_from_jax_state():
    """A port pipeline resumes from a JAX pipeline's state after one step
    (``state_from_jax``): the next step is equal on both sides."""
    words, want = jax_run("time2", "FIR-nopeaks")
    mesh = make_link_mesh(4, device="cpu")
    pipe = APAPipeline(N_LINKS, configs("FIR-nopeaks")[1], mesh=mesh,
                       backend="pallas", time2_feed=True)
    pipe.state = state_from_jax(want[0][4], mesh)
    assert all(isinstance(v, parallel.Sharded) and
               v.shards.shape == (4,) for v in pipe.state.values())
    pipe.dropped_hits = want[0][3]
    hits, n_hits, total = pipe.process(words)
    assert_step_equal((hits, n_hits, total, pipe.dropped_hits, pipe.state),
                      want[1], "resumed from the JAX state")


DET_CASES = [("scan", ((2, 1), (2, 4))), ("pallas", ((2, 2), (2, 1))),
             ("time2", ((2, 4), (2, 2)))]


@pytest.mark.parametrize("ingest,grids", DET_CASES,
                         ids=[c[0] for c in DET_CASES])
def test_detector_pipeline_matches_jax(ingest, grids):
    """2 APAs x 4 links: per-APA totals, hits, n_hits, dropped and state
    over two steps on ('apa', 'link') meshes of 1, 2 and 4 link shards."""
    words, _ = make_apa_words(2, 4, 2, seed=9)
    kw = dict(INGESTS[ingest])
    jkw = dict(kw, interpret=True) if kw["backend"] == "pallas" else kw
    jcfg, cfg = configs("AbsRS")
    det = jpar.DetectorPipeline(2, 4, jcfg,
                                mesh=jpar.make_apa_link_mesh(2, 2), **jkw)
    want = []
    for _ in range(2):
        hits, n_hits, totals = det.process(words)
        want.append((np.asarray(hits), np.asarray(n_hits), totals,
                     det.dropped_hits.copy(),
                     {k: np.asarray(v) for k, v in det.state.items()}))
    for grid in grids:
        port = DetectorPipeline(2, 4, cfg,
                                mesh=make_apa_link_mesh(*grid, device="cpu"),
                                **kw)
        for step, w in enumerate(want):
            hits, n_hits, totals = port.process(words)
            np.testing.assert_array_equal(totals, w[2])
            np.testing.assert_array_equal(
                totals, np.asarray(n_hits).sum(axis=1))
            assert_step_equal((hits, n_hits, totals, port.dropped_hits,
                               port.state), w, f"{grid}, step {step}")


def test_mesh_shapes_and_names():
    mesh = make_link_mesh(8, device="cpu")
    assert mesh.axis_names == ("link",) and mesh.devices.shape == (8,)
    assert mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    det = make_apa_link_mesh(2, 4, device="cpu")
    assert det.axis_names == ("apa", "link") and det.devices.shape == (2, 4)
    assert make_apa_link_mesh(3, device="cpu").devices.shape == (3, 1)


def test_mesh_never_falls_back(monkeypatch):
    """Without a named device a mesh takes the visible cards and raises
    when there are too few; the JAX helpers fall back to the CPU pool
    there, the port's do not.  Naming a device puts every shard on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_link_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APAPipeline(2, TPGConfig(threshold=120))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert list(make_link_mesh().devices.flat) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_apa_link_mesh(2).devices.shape == (2, 1)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_link_mesh(4)
    with pytest.raises(ValueError, match=r"need 4 devices \(2 APAs x 2\)"):
        make_apa_link_mesh(2, 2)
    assert list(make_link_mesh(4, device="cuda:1").devices.flat) == \
        [torch.device("cuda", 1)] * 4


def _raised(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


def test_errors_match_jax():
    """The constructors refuse what the JAX ones refuse, with the same
    messages."""
    jmesh, mesh = jpar.make_link_mesh(2), make_link_mesh(2, device="cpu")
    jcfg, cfg = JaxConfig(threshold=120), TPGConfig(threshold=120)
    for kw in (dict(backend="scan", fused_unpack=True),
               dict(backend="scan", time2_feed=True),
               dict(backend="pallas", fused_unpack=True, time2_feed=True)):
        assert _raised(lambda: APAPipeline(2, cfg, mesh=mesh, **kw)) == \
            _raised(lambda: jpar.APAPipeline(2, jcfg, mesh=jmesh, **kw))
    with pytest.raises(ValueError, match="divide evenly"):
        APAPipeline(3, cfg, mesh=mesh)
    jdet, det = jpar.make_apa_link_mesh(2, 2), \
        make_apa_link_mesh(2, 2, device="cpu")
    for args in ((4, 4), (2, 3)):
        assert _raised(lambda: DetectorPipeline(*args, cfg, mesh=det)) == \
            _raised(lambda: jpar.DetectorPipeline(*args, jcfg, mesh=jdet))
    assert _raised(lambda: DetectorPipeline(
        2, 2, cfg, mesh=det, time2_feed=True)) == _raised(
        lambda: jpar.DetectorPipeline(2, 2, jcfg, mesh=jdet,
                                      time2_feed=True))
    with pytest.raises(ValueError, match="'link'"):
        parallel.make_apa_step(det, cfg)
    with pytest.raises(ValueError, match="'apa', 'link'"):
        parallel.make_detector_step(mesh, cfg)


def test_seeding_is_host_side(monkeypatch):
    """``init_state`` and the first batch's seeding run on the host: a
    pipeline on a CPU mesh never asks torch.cuda anything (the JAX
    pipeline must not touch the default device,
    ``tests/test_graft_entry.py:45-67``), and the pedestals are the first
    sample."""
    def refuse(*_a, **_k):
        raise AssertionError("the pipeline asked torch.cuda")

    for name in ("is_available", "device_count", "current_device",
                 "current_stream", "Stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    from fdreadoutlibs_tpu_torch.formats import wibeth
    words = np.zeros((2, wibeth.N_TIME_SAMPLES, 28), dtype=np.uint32)
    frames = wibeth.empty_frames(1)
    wibeth.set_adcs(frames, np.full((1, 64, 64), 800, np.uint16))
    words[:] = wibeth.frames_bytes_to_u32(frames)[0]
    for backend in ("scan", "pallas"):
        pipe = APAPipeline(2, TPGConfig(threshold=120),
                           mesh=make_link_mesh(2, device="cpu"),
                           backend=backend)
        hits, n_hits, total = pipe.process(words)
        assert total == 0
        assert (np.asarray(pipe.state["pedestals"]) == 800).all()


def test_state_reads_after_every_step():
    """``state`` is read from the carried stacks after each step (views on
    the shards' devices); assigning it back changes nothing."""
    words, want = jax_run("fused", "AbsRS")
    pipe = APAPipeline(N_LINKS, configs("AbsRS")[1],
                       mesh=make_link_mesh(2, device="cpu"),
                       backend="pallas", fused_unpack=True)
    for w in want:
        pipe.process(words)
        state = pipe.state
        assert state["fir_prev"].shape == (N_LINKS, 8, 64)
        assert state["pedestals"].shape == (N_LINKS, 64)
        for k in w[4]:
            np.testing.assert_array_equal(np.asarray(state[k]), w[4][k])
        pipe.state = state
        for k in w[4]:
            np.testing.assert_array_equal(np.asarray(pipe.state[k]),
                                          w[4][k])


def test_sharded_compaction_equals_per_link_loop():
    """The per-link compactions with a leading link axis (one call a shard)
    equal a loop of the single-block calls, link by link."""
    from fdreadoutlibs_tpu_torch.ops.hits import compact_slot_words
    from fdreadoutlibs_tpu_torch.ops.scan import compact_hits_device
    rng = np.random.default_rng(3)
    L, K, C = 3, 6, 64
    w2 = torch.from_numpy(rng.integers(0, 40, size=(L, K, C))
                          .astype(np.int32) * (rng.random((L, K, C)) < 0.2))
    w0 = torch.from_numpy(rng.integers(0, 2**31, size=(L, K, C))
                          .astype(np.int32))
    w1 = torch.from_numpy(rng.integers(0, 2**31, size=(L, K, C))
                          .astype(np.int32))
    for mh in (4, 512):
        for peak in (w1, None):
            hits, n = compact_slot_words(w0, peak, w2, mh)
            for link in range(L):
                h, nl = compact_slot_words(
                    w0[link], None if peak is None else peak[link], w2[link],
                    mh)
                assert torch.equal(hits[link], h) and int(n[link]) == int(nl)
    closed = torch.from_numpy(rng.random((L, 32, C)) < 0.05)
    rec = {f: torch.from_numpy(rng.integers(0, 999, size=(L, 32, C))
                               .astype(np.int32))
           for f in ("charge", "tover", "peak_adc", "peak_time")}
    for mh in (5, 1024):
        hits, n, d = compact_hits_device(closed, rec, mh)
        for link in range(L):
            h, nl, dl = compact_hits_device(
                closed[link], {f: r[link] for f, r in rec.items()}, mh)
            assert torch.equal(hits[link], h)
            assert int(n[link]) == int(nl) and int(d[link]) == int(dl)


def test_sharded_array_gathers_like_a_jax_array():
    grid = (2, 3)
    parts = [torch.arange(8).reshape(1, 2, 4) + 100 * i for i in range(6)]
    arr = parallel.Sharded(parts, grid)
    whole = np.concatenate([np.concatenate(
        [parts[3 * a + d].numpy() for d in range(3)], axis=1)
        for a in range(2)], axis=0)
    assert arr.shape == whole.shape == (2, 6, 4)
    np.testing.assert_array_equal(np.asarray(arr), whole)
    np.testing.assert_array_equal(arr[1, 2:4], whole[1, 2:4])
    assert len(arr) == 2 and arr.dtype == torch.int64
    with pytest.raises(ValueError, match="shards for a grid"):
        parallel.Sharded(parts[:5], grid)


def test_dataclass_configs_unchanged():
    """The pipelines take the port's TPGConfig as the JAX ones take
    theirs (frozen dataclasses with the same fields)."""
    jcfg, cfg = configs("FIR-nopeaks")
    assert dataclasses.asdict(jcfg).keys() == dataclasses.asdict(cfg).keys()
