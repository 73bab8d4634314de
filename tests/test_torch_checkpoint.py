"""The port's checkpoint/resume (``utils/checkpoint.py``, the npz half)
against the JAX package's on the CPU: a processor checkpointed mid-stream,
with a hit in flight, and restored into a fresh processor emits the TPs of
the uninterrupted run, bit for bit (tolerance 0), for the WIBEth processor
(reference backend and the kernel route's plain version, whose state lives
in ``_dev_state``) and the DAPHNE-stream processor (``_pallas_stack``); and
the checkpoint files cross between the packages."""

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.formats import daphne as jdaphne
from fdreadoutlibs_tpu.ops import patterns
from fdreadoutlibs_tpu.stream import WIBEthFrameProcessor as JWIBEth
from fdreadoutlibs_tpu.stream.daphne import \
    DAPHNEStreamFrameProcessor as JDAPHNE
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu.utils import checkpoint as jcheckpoint
from fdreadoutlibs_tpu_torch.stream import (DAPHNEStreamFrameProcessor,
                                            WIBEthFrameProcessor)
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

WIBETH_CONF = {"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
               "tpg_threshold": 499, "tp_timeout": 100_000}


def _wibeth(backend, jax=False):
    p = JWIBEth(tp_sink=JQueueSender()) if jax else \
        WIBEthFrameProcessor(tp_sink=QueueSender(), device="cpu")
    conf = dict(WIBETH_CONF, tpg_backend=backend)
    if jax and backend == "pallas":
        conf["tpg_pallas_interpret"] = True
    p.conf(conf)
    p.start()
    return p


def _golden_frames():
    # the hill starts 60 ticks into each frame: every hit spans a frame
    # boundary, so the checkpoint after frame 2 has a hit in flight
    frames, _ = patterns.pattern_frames(
        "golden", first_timestamp=10_000, crate_id=1, slot_id=2,
        stream_id=3, n_frames=4, channel=7, offset=60)
    return frames


def _tps(proc):
    return np.concatenate(proc.tp_sink.drain())


@pytest.mark.parametrize("backend", ["reference", "scan", "pallas"])
def test_wibeth_resume_mid_stream_bitexact(backend, tmp_path):
    frames = _golden_frames()
    cont = _wibeth(backend)
    cont.process(frames.copy())
    want = _tps(cont)

    p1 = _wibeth(backend)
    p1.process(frames[:2].copy())
    if backend == "pallas":
        assert p1._dev_state is not None and p1._state_stale
    assert p1.current_state()["hit_tover"][7] > 0      # a hit in flight
    ckpt = checkpoint.checkpoint_processor(p1, tmp_path / "ckpt.npz")
    part1 = p1.tp_sink.drain()

    p2 = _wibeth(backend)
    checkpoint.restore_processor(p2, ckpt)
    assert p2._dev_state is None and not p2._state_stale
    p2.process(frames[2:].copy())
    got = np.concatenate(part1 + p2.tp_sink.drain())
    assert len(want) == 3          # the fourth hill is still open
    np.testing.assert_array_equal(got, want)
    assert p2.metrics.count("num_ts_errors") == 0
    assert p2.metrics.count("num_seq_id_errors") == 0
    # the JAX processor's uninterrupted run emits the same TPs
    ref = _wibeth(backend, jax=True)
    ref.process(frames.copy())
    np.testing.assert_array_equal(got, _tps(ref))


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_checkpoint_files_cross_packages(backend, tmp_path):
    """A checkpoint written by either package restores into the other and
    resumes to the same TPs."""
    frames = _golden_frames()
    for src_jax in (True, False):
        src = _wibeth(backend, jax=src_jax)
        src.process(frames[:2].copy())
        write = (jcheckpoint if src_jax else checkpoint).checkpoint_processor
        ckpt = write(src, tmp_path / f"c{int(src_jax)}.npz")
        part1 = src.tp_sink.drain()
        dst = _wibeth(backend, jax=not src_jax)
        (checkpoint if src_jax else jcheckpoint).restore_processor(dst, ckpt)
        dst.process(frames[2:].copy())
        got = np.concatenate(part1 + dst.tp_sink.drain())
        cont = _wibeth(backend)
        cont.process(frames.copy())
        np.testing.assert_array_equal(got, _tps(cont))


def test_save_and_load_state_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    state = {"pedestals": rng.integers(0, 900, 64, dtype=np.int32),
             "fir_prev": rng.integers(-5, 5, (8, 64), dtype=np.int32)}
    meta = {"previous_ts": 123456789, "first_hit": False,
            "register_channels": np.arange(64)}
    checkpoint.save_state(tmp_path / "a.npz", state, **meta)
    jcheckpoint.save_state(tmp_path / "b.npz", state, **meta)
    for path in ("a.npz", "b.npz"):
        st, m = checkpoint.load_state(tmp_path / path)
        jst, jm = jcheckpoint.load_state(tmp_path / path)
        assert set(st) == set(jst) == set(state)
        for k in state:
            np.testing.assert_array_equal(st[k], jst[k])
        assert m["previous_ts"] == jm["previous_ts"] == 123456789
        assert m["first_hit"] is jm["first_hit"] is False
        np.testing.assert_array_equal(m["register_channels"],
                                      jm["register_channels"])


def _daphne_batches():
    def make_batch(seed, pulse_ch):
        r = np.random.default_rng(seed)
        sc = jdaphne.empty_superchunks(2, stream=True)
        frames = jdaphne.superchunk_frames(sc, stream=True) \
            .reshape(-1, jdaphne.STREAM_FRAME_SIZE)
        adcs = (700 + r.normal(0, 15, size=(frames.shape[0], 64, 4))) \
            .astype(np.uint16)
        adcs[12:20, 30:50, pulse_ch] += 400
        jdaphne.stream_set_adcs(frames, adcs)
        return sc
    return [make_batch(s, ch) for s, ch in ((1, 0), (2, 1), (3, 2))]


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_daphne_stream_resume_bitexact(backend, tmp_path):
    def make(jax=False):
        p = JDAPHNE(tp_sink=JQueueSender()) if jax else \
            DAPHNEStreamFrameProcessor(tp_sink=QueueSender(), device="cpu")
        p.conf({"enable_tpg": True, "tpg_threshold": 60,
                "tpg_backend": backend, "tpg_pallas_interpret": True})
        p.start()
        return p

    batches = _daphne_batches()
    cont = make()
    for b in batches:
        cont.process(b.copy())
    want = _tps(cont)

    p1 = make()
    p1.process(batches[0].copy())
    if backend == "pallas":
        assert p1._pallas_stack is not None and p1._state_stale
    ckpt = checkpoint.checkpoint_processor(p1, tmp_path / "daphne.npz")
    part1 = p1.tp_sink.drain()
    p2 = make()
    checkpoint.restore_processor(p2, ckpt)
    assert p2._pallas_stack is None and not p2._state_stale
    for b in batches[1:]:
        p2.process(b.copy())
    got = np.concatenate(part1 + p2.tp_sink.drain())
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    ref = make(jax=True)
    for b in batches:
        ref.process(b.copy())
    np.testing.assert_array_equal(got, _tps(ref))
