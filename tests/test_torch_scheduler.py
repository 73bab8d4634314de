"""The port's ``MultiAPAScheduler`` (``apps/scheduler.py``,
``device="cpu"``: K2's plain version) against the JAX scheduler in Pallas
interpret mode: the same frames submitted in the same interleaved order
give the same (hits, dropped) from every ``submit``, ``collect`` and
``flush``, the same carried state per APA (the JAX stack read through
``ops.tpg.state_from_jax``) and the same ``get_info``.  Each APA also
equals a single-APA ``StreamingIngest`` of its own batches (isolation).
Inputs are made by numpy from a seed; integer pipeline, tolerance 0."""

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.apps.scheduler import MultiAPAScheduler as JScheduler
from fdreadoutlibs_tpu.formats import wibeth as jwibeth
from fdreadoutlibs_tpu.ops import TPGConfig
from fdreadoutlibs_tpu.ops.hits import sort_hits
from fdreadoutlibs_tpu_torch.apps.scheduler import MultiAPAScheduler
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.ops.ingest import StreamingIngest

torch.set_num_threads(1)

GOLDEN = np.array([500, 502, 504, 505, 506, 505, 504, 502, 500])


def _batch(rng, n_links, n_frames, hots=()):
    frames = np.zeros((n_links, n_frames, jwibeth.FRAME_SIZE), np.uint8)
    adcs = (800 + rng.normal(0, 8, (n_links, n_frames, 64, 64))) \
        .astype(np.uint16)
    for link, chan, t, amp in hots:
        f, t = divmod(t, 64)
        seg = (GOLDEN * amp // 500).astype(np.uint16)[: 64 - t]
        adcs[link, f, t:t + len(seg), chan] += seg
    for link in range(n_links):
        jwibeth.set_adcs(frames[link], adcs[link])
    return frames


def _same(got, want):
    if want is None:
        assert got is None
        return
    hits, dropped = got
    np.testing.assert_array_equal(hits, sort_hits(hits))   # canonical
    np.testing.assert_array_equal(hits, sort_hits(want[0]))
    assert dropped == want[1]


def _same_state(sched, jsched):
    for apa in range(sched.n_apas):
        want = tpg.state_from_jax(np.asarray(jsched._stacks[apa]),
                                  sched.n_channels)
        assert torch.equal(sched._stacks[apa], want), apa


def _drive(cfg, n_apas, n_links, order, batches, **kw):
    sched = MultiAPAScheduler(cfg, n_apas=n_apas, n_links=n_links,
                              device="cpu", **kw)
    jsched = JScheduler(cfg, n_apas=n_apas, n_links=n_links, interpret=True,
                        **kw)
    got = {a: [] for a in range(n_apas)}
    for apa, frames in zip(order, batches):
        out = sched.submit(apa, frames)
        _same(out, jsched.submit(apa, frames))
        if out is not None:
            got[apa].append(out)
    _same_state(sched, jsched)
    flushed, jflushed = sched.flush(), jsched.flush()
    assert set(flushed) == set(jflushed)
    for apa in flushed:
        _same(flushed[apa], jflushed[apa])
        got[apa].append(flushed[apa])
    assert sched.get_info() == jsched.get_info()
    return sched, got


def test_two_apas_interleaved_match_jax():
    rng = np.random.default_rng(0)
    L, NF, NB = 2, 2, 3
    cfg = TPGConfig(threshold=480)
    order, batches = [], []
    for b in range(NB):
        for apa in range(2):
            hots = [(apa, 3 + apa, 10 * (b + 1), 500)] if b != 1 else []
            order.append(apa)
            batches.append(_batch(rng, L, NF, hots))
    sched, got = _drive(cfg, 2, L, order, batches, k_slots=4)
    for apa in range(2):
        hits = np.concatenate([h for h, _ in got[apa]])
        assert set(hits["channel"]) == {apa * 64 + 3 + apa}
        assert len(hits) == 2
    assert sched.get_info()["batches"] == [NB, NB]


def test_random_order_memory_factors_and_drops_match_jax():
    """Three APAs in a seeded shuffled order with back-to-back repeats,
    AbsRS with per-channel memory factors, and more closes per chunk than
    slots (dropped counts compared too)."""
    rng = np.random.default_rng(5)
    L, NF, n_apas = 2, 2, 3
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    C = L * 64
    rmf = np.where(np.arange(C) % 3 == 0, 0, cfg.rs_memory_factor_x10)
    order = [int(a) for a in rng.permutation(np.repeat(np.arange(n_apas),
                                                       3))] + [1, 1]
    batches = []
    for _ in order:
        hots = [(int(rng.integers(L)), int(rng.integers(64)),
                 int(rng.integers(0, NF * 64 - 9)),
                 int(rng.integers(500, 3000))) for _ in range(12)]
        # a channel that closes many times in one chunk: k_slots overflow
        hots += [(0, 9, t, 900) for t in range(0, 64, 11)]
        batches.append(_batch(rng, L, NF, hots))
    sched, got = _drive(cfg, n_apas, L, order, batches, tc=64, k_slots=1,
                        rs_memory_factor=rmf)
    assert sum(d for a in got for _, d in got[a]) > 0
    assert sum(len(h) for a in got for h, _ in got[a]) > 0


def test_each_apa_equals_single_apa_ingest():
    rng = np.random.default_rng(9)
    L, NF, n_apas = 2, 2, 3
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    sched = MultiAPAScheduler(cfg, n_apas=n_apas, n_links=L, k_slots=2,
                              device="cpu")
    ingests = [StreamingIngest(cfg, L, k_slots=2, device_compact=True,
                               max_hits=max(2048, 2 * L * 64), device="cpu")
               for _ in range(n_apas)]
    for apa in [0, 1, 2, 2, 0, 1, 0]:
        frames = _batch(rng, L, NF, [(1, apa, 40, 2000)])
        _same(sched.submit(apa, frames), ingests[apa].submit(frames))
    for apa, out in sched.flush().items():
        _same(out, ingests[apa].flush())
        assert torch.equal(sched._stacks[apa], ingests[apa].state)


def test_refusals_match_jax():
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    for cls, kw in ((MultiAPAScheduler, {"device": "cpu"}),
                    (JScheduler, {"interpret": True})):
        with pytest.raises(ValueError, match="rs_memory_factor"):
            cls(cfg, n_apas=1, n_links=1, rs_memory_factor=np.zeros(5),
                **kw)
        sched = cls(TPGConfig(), n_apas=1, n_links=4, **kw)
        with pytest.raises(ValueError, match="expected 4 links"):
            sched.submit(0, np.zeros((2, 1, jwibeth.FRAME_SIZE), np.uint8))
        assert sched.k_slots == 2 and sched.collect(0) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MultiAPAScheduler(cfg, n_apas=1, n_links=1)   # "cuda": no card
