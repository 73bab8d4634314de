"""The port's sharded checkpoint (``utils/checkpoint.save_sharded_state`` /
``load_sharded_state``), ``entry.dryrun_multichip`` and ``probes/soak.py``
on the CPU, against the JAX package where it has a counterpart that runs
here: the orbax round trip of ``tests/test_config_checkpoint.py:89-144``,
``__graft_entry__.dryrun_multichip`` and the soak's numpy oracle
(``scripts/soak_hardware.py:68-90``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import fdreadoutlibs_tpu.parallel as jpar
from fdreadoutlibs_tpu.ops import TPGConfig as JaxConfig

from fdreadoutlibs_tpu_torch.entry import dryrun_multichip
from fdreadoutlibs_tpu_torch.ops import TPGConfig
from fdreadoutlibs_tpu_torch.parallel import (APAPipeline, DetectorPipeline,
                                              Sharded, make_apa_link_mesh,
                                              make_link_mesh)
from fdreadoutlibs_tpu_torch.probes import soak
from fdreadoutlibs_tpu_torch.utils.checkpoint import (load_sharded_state,
                                                      save_sharded_state)
from tests.test_detector_pipeline import make_apa_words
from tests.test_parallel import make_words

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__  # noqa: E402

torch.set_num_threads(1)

CFG = TPGConfig.from_raw("AbsRS", threshold=150)


def pipe_on(n_shards, **kw):
    return APAPipeline(8, CFG, mesh=make_link_mesh(n_shards, device="cpu"),
                       backend="pallas", **kw)


def assert_states_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("saved,restored", [(8, 8), (8, 2), (2, 8)])
def test_sharded_resume_is_bit_exact(tmp_path, saved, restored):
    """Checkpoint after batch 1 on ``saved`` shards, restore into a fresh
    pipeline of ``restored`` shards, replay batch 2: hits, n_hits, total,
    dropped and state equal the uninterrupted run."""
    words1, _ = make_words(8, 2, seed=31)
    words2, _ = make_words(8, 2, seed=32)
    cont = pipe_on(saved, time2_feed=True)
    cont.process(words1)
    save_sharded_state(tmp_path / "ckpt", cont.state)
    dropped1 = cont.dropped_hits
    want = cont.process(words2)
    fresh = pipe_on(restored, time2_feed=True)
    fresh.init_state(np.zeros((8, 64), np.int32))
    fresh.state = load_sharded_state(tmp_path / "ckpt", fresh.state)
    assert all(v.shards.shape == (restored,) for v in fresh.state.values())
    got = fresh.process(words2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[2] == want[2] > 0
    assert fresh.dropped_hits == cont.dropped_hits - dropped1
    assert_states_equal(fresh.state, cont.state)


def test_checkpoint_files_name_the_mesh_and_links(tmp_path):
    """One npz a shard and an index of the grid and each shard's links."""
    import json
    pipe = pipe_on(4)
    pipe.process(make_words(8, 1, seed=3)[0])
    save_sharded_state(tmp_path / "c", pipe.state)
    index = json.loads((tmp_path / "c" / "index.json").read_text())
    assert index["grid"] == [4]
    assert index["shards"] == [f"shard_{i:05d}.npz" for i in range(4)]
    assert index["keys"]["pedestals"]["shape"] == [8, 64]
    assert index["keys"]["fir_prev"]["shape"] == [8, 8, 64]
    assert [s[0] for s in index["keys"]["pedestals"]["slices"]] == \
        [[0, 2], [2, 4], [4, 6], [6, 8]]
    shard = np.load(tmp_path / "c" / "shard_00001.npz")
    np.testing.assert_array_equal(
        shard["pedestals"], np.asarray(pipe.state["pedestals"])[2:4])
    # a plain dict of arrays round-trips as it is
    plain = {k: np.asarray(v) for k, v in pipe.state.items()}
    save_sharded_state(tmp_path / "p", plain)
    back = load_sharded_state(tmp_path / "p", plain)
    assert_states_equal(back, plain)
    assert isinstance(load_sharded_state(tmp_path / "c", pipe.state)
                      ["rs"], Sharded)


def test_detector_state_round_trip(tmp_path):
    """The 2-D ('apa' x 'link') state checkpoints and resumes bit-exactly,
    onto a mesh of another link-shard count."""
    words, _ = make_apa_words(2, 4, n_frames=2, seed=22)
    det = DetectorPipeline(2, 4, CFG,
                           mesh=make_apa_link_mesh(2, 2, device="cpu"))
    det.process(words)
    save_sharded_state(tmp_path / "det", det.state)
    _, n_cont, tot_cont = det.process(words)
    for shards in (2, 4):
        det2 = DetectorPipeline(
            2, 4, CFG, mesh=make_apa_link_mesh(2, shards, device="cpu"))
        det2.init_state(np.zeros((2, 4, 64), np.int32))
        det2.state = load_sharded_state(tmp_path / "det", det2.state)
        _, n_res, tot_res = det2.process(words)
        np.testing.assert_array_equal(np.asarray(n_res), np.asarray(n_cont))
        np.testing.assert_array_equal(tot_res, tot_cont)
        assert_states_equal(det2.state, det.state)


def test_resumed_state_equals_jax_orbax_round_trip(tmp_path):
    """The JAX round trip of ``tests/test_config_checkpoint.py:89-144``
    (orbax, 4 devices, the scan backend) and the port's (npz, 4 shards) on
    the same words: the resumed states and step-2 n_hits are equal."""
    from fdreadoutlibs_tpu.utils.checkpoint import (
        load_sharded_state as jax_load, save_sharded_state as jax_save)
    words, _ = make_words(4, n_frames=2, seed=21)
    jcfg = JaxConfig(threshold=120)
    jpipe = jpar.APAPipeline(4, jcfg, mesh=jpar.make_link_mesh(4))
    jpipe.process(words)
    jax_save(tmp_path / "jax", jpipe.state)
    jpipe2 = jpar.APAPipeline(4, jcfg, mesh=jpar.make_link_mesh(4))
    jpipe2.process(words)
    jpipe2.state = jax_load(tmp_path / "jax", jpipe2.state)
    _, jn, _ = jpipe2.process(words)

    cfg = TPGConfig(threshold=120)
    mesh = make_link_mesh(4, device="cpu")
    pipe = APAPipeline(4, cfg, mesh=mesh)
    pipe.process(words)
    save_sharded_state(tmp_path / "port", pipe.state)
    pipe2 = APAPipeline(4, cfg, mesh=mesh)
    pipe2.process(words)
    pipe2.state = load_sharded_state(tmp_path / "port", pipe2.state)
    _, n, _ = pipe2.process(words)
    np.testing.assert_array_equal(np.asarray(n), np.asarray(jn))
    assert_states_equal(pipe2.state,
                        {k: np.asarray(v) for k, v in jpipe2.state.items()})


def test_dryrun_multichip_matches_jax_line(capsys):
    """``dryrun_multichip(n, device="cpu")`` runs every part of the JAX
    dry run and prints its OK line, the same line as the JAX one."""
    dryrun_multichip(2, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    __graft_entry__.dryrun_multichip(2)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.startswith("dryrun_multichip OK: 2 devices, 4 links")
    assert "ckpt-resume bit-exact OK" in port_line
    assert port_line == jax_line


def test_dryrun_multichip_4_shards(capsys):
    dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 4 devices, 8 links")
    assert "apa40: 20 links/4 devices" in line
    assert "composition app arms tpc/pds/tde hits: 1/1/1" in line


@pytest.mark.parametrize("alg", ["AbsRS", "FIR"])
def test_soak_oracle_equals_the_scripts(alg):
    """The soak's expected count is the JAX script's numpy oracle on the
    same 8 pulse channels, at the script's full size (2560 x 4096)."""
    from fdreadoutlibs_tpu.ops.chanstate import (init_chanstate,
                                                 seed_chanstate)
    from fdreadoutlibs_tpu.ops.reference import process_window_reference
    cfg, adcs, rmf, pulse_chans = soak.make_stream(4096, 2560, alg)
    jcfg = JaxConfig.from_raw(alg, threshold=5, track_peaks=False) \
        if alg == "FIR" else JaxConfig.from_raw(alg, threshold=150)
    # the script's lines :68-90, verbatim in effect
    sub = adcs[:, pulse_chans]
    st = seed_chanstate(init_chanstate(len(pulse_chans)), sub[0],
                        rmf[pulse_chans])
    want = []
    for _ in range(3):
        h, st = process_window_reference(sub, st, jcfg)
        want.append(len(h))
    assert list(pulse_chans) == [5, 300, 777, 1201, 1600, 1999, 2222, 2500]
    assert soak.oracle(cfg, adcs, rmf, pulse_chans) == want
    assert want[0] > 0


@pytest.mark.parametrize("ingest", soak.INGESTS)
def test_soak_runs_each_ingest(ingest, capsys):
    """The soak at a small size on the CPU (the plain versions), through
    its command line: the exact count, nothing dropped, the resume
    bit-exact."""
    args = ["--windows", "3", "--ticks", "1024", "--channels", "128",
            "--device", "cpu"]
    args += {"plain": [], "fused": ["--fused"],
             "words14": ["--words14-feed"],
             "time2": ["--time2-feed"]}[ingest]
    if ingest == "time2":
        args += ["--alg", "FIR"]
    assert soak.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SOAK OK"
    import json
    rec = json.loads(out[-2])
    assert rec["ingest"] == ingest and rec["hits"] == rec["expected"] > 0
    assert rec["dropped"] == 0 and rec["state_bitexact_after_resume"]
