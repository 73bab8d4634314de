"""The port's CLI (``python -m fdreadoutlibs_tpu_torch.cli``) and what it
runs on — ``ops/patterns``, ``stream/emulator`` and the channel-map tools —
against the JAX package on the CPU (``--device cpu``: the kernels' plain
versions).  Each command runs through both CLIs on the same input files,
each in a directory of its own with the same file names: the printed text
must be equal line for line (a JSON line without its wall-clock keys),
the written files byte for byte, and the exit codes equal.  Inputs are
made by numpy from a seed; tolerance 0 throughout."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu import cli as jcli
from fdreadoutlibs_tpu.formats.adapters import get_adapter as jget_adapter
from fdreadoutlibs_tpu.formats.fragment import build_fragment
from fdreadoutlibs_tpu.ops import patterns as jpatterns
from fdreadoutlibs_tpu.stream import emulator as jemulator
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu.tp.recorder import FragmentRecorder
from fdreadoutlibs_tpu.utils import channel_map as jchannel_map
from fdreadoutlibs_tpu_torch import cli
from fdreadoutlibs_tpu_torch.formats import wibeth
from fdreadoutlibs_tpu_torch.formats.adapters import get_adapter
from fdreadoutlibs_tpu_torch.ops import patterns
from fdreadoutlibs_tpu_torch.stream import emulator
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender
from fdreadoutlibs_tpu_torch.utils import channel_map

torch.set_num_threads(1)

# wall-clock keys of the printed JSON; every other key must be equal
TIMINGS = {"wall_seconds", "realtime_factor", "wall_s", "gsps_wall"}


def _norm(line: str):
    if line.startswith("{"):
        blob = json.loads(line)
        return {k: v for k, v in blob.items() if k not in TIMINGS}
    return line


def _run(main, argv, where: Path, capsys, monkeypatch, device=True):
    where.mkdir(exist_ok=True)
    monkeypatch.chdir(where)
    capsys.readouterr()
    rc = main(argv + (["--device", "cpu"] if device is True else []))
    out = capsys.readouterr().out
    return rc, [_norm(ln) for ln in out.splitlines()]


def _both(argv, tmp_path, capsys, monkeypatch, inputs=(), device=False):
    """Run argv through the JAX CLI and the port's (plus ``--device cpu``
    when ``device``) in sibling directories holding copies of ``inputs``;
    assert equal exit codes, text and written files.  Returns (rc, lines,
    the port's directory)."""
    res = {}
    for name, main, dev in (("jax", jcli.main, False),
                            ("port", cli.main, device)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        for src in inputs:
            (d / Path(src).name).write_bytes(Path(src).read_bytes())
        res[name] = _run(main, argv, d, capsys, monkeypatch, dev)
    assert res["jax"][0] == res["port"][0]
    assert res["port"][1] == res["jax"][1]
    files = {p.relative_to(tmp_path / "jax") for p in
             (tmp_path / "jax").rglob("*") if p.is_file()}
    assert files == {p.relative_to(tmp_path / "port") for p in
                     (tmp_path / "port").rglob("*") if p.is_file()}
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    return res["port"][0], res["port"][1], tmp_path / "port"


@pytest.fixture
def noisy_file(tmp_path):
    """A 4-frame WIBEth file: noise on a pedestal plus two pulses."""
    rng = np.random.default_rng(11)
    frames = wibeth.empty_frames(4)
    adcs = (900 + rng.normal(0, 20, size=(4, 64, 64))).astype(np.uint16)
    adcs[1, 10:20, 5] += 1500
    adcs[2, 30:34, 40] += 900
    wibeth.set_adcs(frames, adcs)
    wibeth.fake_timestamps(frames, 0x1000)
    wibeth.fake_seq_ids(frames, 0)
    path = tmp_path / "noisy.bin"
    frames.tofile(path)
    return path


# ---- the commands ---------------------------------------------------------

def test_make_zeros(tmp_path, capsys, monkeypatch):
    rc, lines, _ = _both(["make-zeros", "-o", "z.bin", "-n", "6"], tmp_path,
                         capsys, monkeypatch)
    assert rc == 0 and lines


@pytest.mark.parametrize("pattern", list(patterns.PATTERNS))
def test_pattern_generator(pattern, tmp_path, capsys, monkeypatch):
    z = tmp_path / "z.bin"
    emulator.all_zeros_wibeth_file(z, n_frames=3)
    rc, lines, _ = _both(["pattern-generator", "-f", "z.bin", "-p", pattern,
                          "-n", "2", "-i", "5", "-o", "3",
                          "--save-trigprim"], tmp_path, capsys, monkeypatch,
                         inputs=[z])
    assert rc == 0 and any(isinstance(ln, dict) for ln in lines)


@pytest.mark.parametrize("impl", ["reference", "scan", "pallas"])
@pytest.mark.parametrize("algorithm,threshold", [("SimpleThreshold", 499),
                                                 ("AbsRS", 150)])
def test_tpg_emulator(impl, algorithm, threshold, noisy_file, tmp_path,
                      capsys, monkeypatch):
    rc, lines, _ = _both(["tpg-emulator", "-f", "noisy.bin", "-a", algorithm,
                          "-t", str(threshold), "-i", impl,
                          "--save-adc-data", "adc.csv",
                          "--save-trigprim", "tps.txt"], tmp_path, capsys,
                         monkeypatch, inputs=[noisy_file], device=True)
    assert rc == 0 and lines[-1]["hits"] > 0


def test_golden_round_trip(tmp_path, capsys, monkeypatch):
    """make-zeros -> pattern-generator -p golden -> tpg-emulator -i pallas:
    exactly one golden hit per frame comes out (the first on a zero
    pedestal: charge 4528, peak 506)."""
    rc, _, d = _both(["make-zeros", "-o", "z.bin", "-n", "2"], tmp_path,
                     capsys, monkeypatch)
    _both(["pattern-generator", "-f", "z.bin", "-p", "golden",
           "--output", "g.bin"], tmp_path, capsys, monkeypatch)
    rc, lines, d = _both(["tpg-emulator", "-f", "g.bin", "-i", "pallas",
                          "--save-trigprim", "tps.txt"], tmp_path, capsys,
                         monkeypatch, device=True)
    assert rc == 0 and lines[-1]["hits"] == 2
    rows = (d / "tps.txt").read_text().splitlines()[1:]
    assert len(rows) == 2 and rows[0].split(",")[4:6] == ["4528", "506"]


def test_frame_reader_and_modifier(noisy_file, tmp_path, capsys,
                                   monkeypatch):
    rc, lines, _ = _both(["frame-reader", "-f", "noisy.bin", "-n", "3",
                          "--dump-adcs", "--adc-stride", "32"], tmp_path,
                         capsys, monkeypatch, inputs=[noisy_file])
    assert rc == 0 and len(lines) == 3 * 3
    rc, _, _ = _both(["frame-modifier", "-f", "noisy.bin", "--set-channel",
                      "9", "--set-value", "777", "--set-timestamp", "4096",
                      "--output", "mod.bin"], tmp_path, capsys, monkeypatch)
    assert rc == 0


@pytest.mark.parametrize("backends", [["reference", "scan"],
                                      ["reference", "scan", "pallas"]])
def test_compare_backends(backends, noisy_file, tmp_path, capsys,
                          monkeypatch):
    rc, lines, _ = _both(["compare-backends", "-f", "noisy.bin", "-a",
                          "AbsRS", "-t", "150", "-b", *backends], tmp_path,
                         capsys, monkeypatch, inputs=[noisy_file],
                         device=True)
    assert rc == 0 and lines[-1].endswith("MATCH")


def test_compare_tp_files(tmp_path, capsys, monkeypatch):
    hdr = ("channel,time_start,time_over_threshold,time_peak,adc_integral,"
           "adc_peak,type\n")
    a, b, c = (tmp_path / n for n in ("a.txt", "b.txt", "c.txt"))
    a.write_text(hdr + "1,100,32,110,500,250,1\n2,200,64,220,900,400,1\n")
    b.write_text(hdr + "2,200,64,220,900,400,1\n1,100,32,110,500,250,1\n")
    c.write_text(hdr + "1,100,32,110,500,250,1\n")
    rc, _, _ = _both(["compare-tp-files", "a.txt", "b.txt"], tmp_path,
                     capsys, monkeypatch, inputs=[a, b, c])
    assert rc == 0
    rc, lines, _ = _both(["compare-tp-files", "a.txt", "c.txt"], tmp_path,
                         capsys, monkeypatch)
    assert rc == 1 and lines[-1].startswith("MISMATCH")


def test_fragment_dump(tmp_path, capsys, monkeypatch):
    store = tmp_path / "store"
    rec = FragmentRecorder(store, run_number=7)
    rng = np.random.default_rng(2)
    for i in range(2):
        rec.write(build_fragment(
            rng.integers(0, 256, size=(3, 7200), dtype=np.uint8),
            run_number=7, trigger_number=i, window_begin=100 * i,
            window_end=100 * i + 50, source_id=3 + i,
            fragment_type="kWIBEth"))
    for d in ("jax", "port"):      # the same store in both directories
        shutil.copytree(store, tmp_path / d / "store")
    for argv in (["fragment-dump", "store"],
                 ["fragment-dump", "store", "-i", "1"],
                 ["fragment-dump", "store", "-i", "0", "-o", "f0.bin"]):
        rc, lines, _ = _both(argv, tmp_path, capsys, monkeypatch)
        assert rc == 0 and lines
    rc, _, _ = _both(["fragment-dump", "store", "-i", "5"], tmp_path, capsys,
                     monkeypatch)
    assert rc == 2


def test_tde_file_creator(tmp_path, capsys, monkeypatch):
    rc, _, _ = _both(["tde-file-creator", "-o", "tde.bin", "-n", "2",
                      "--seed", "3"], tmp_path, capsys, monkeypatch)
    assert rc == 0


@pytest.mark.parametrize("argv", [
    ["channel-map"],
    ["channel-map", "--crate", "1", "--slot", "3", "--stream", "5",
     "--json"],
    ["channel-map", "--frontend", "wib2", "--channels", "256", "--json"],
    ["channel-map", "-n", "IdentityChannelMap", "--stream", "2"],
    ["channel-map", "--write-dump", "dump.txt", "--crate", "2"],
], ids=["default", "json", "wib2", "identity", "write-dump"])
def test_channel_map(argv, tmp_path, capsys, monkeypatch):
    rc, lines, _ = _both(argv, tmp_path, capsys, monkeypatch)
    assert rc == 0 and lines


def test_validate_map(tmp_path, capsys, monkeypatch):
    rc, lines, d = _both(["channel-map", "--write-dump", "dump.txt"],
                         tmp_path, capsys, monkeypatch)
    rc, lines, _ = _both(["validate-map", "-f", "dump.txt",
                          "--derive-femb-table"], tmp_path, capsys,
                         monkeypatch)
    assert rc == 0 and lines[0]["match"] and lines[0]["derived_matches"]
    # a swap inside one FEMB: divergent and underivable, exit 1
    rows = (d / "dump.txt").read_text().splitlines()
    i = next(k for k, r in enumerate(rows) if not r.startswith("#"))
    a, b = rows[i + 10].split(), rows[i + 11].split()
    rows[i + 10] = " ".join([b[0]] + a[1:])
    rows[i + 11] = " ".join([a[0]] + b[1:])
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(rows) + "\n")
    rc, lines, _ = _both(["validate-map", "-f", "bad.txt",
                          "--derive-femb-table"], tmp_path, capsys,
                         monkeypatch, inputs=[bad])
    assert rc == 1 and not lines[0]["match"]
    rc, lines, _ = _both(["validate-map", "-f", "bad.txt", "--crate", "4"],
                         tmp_path, capsys, monkeypatch)
    assert rc == 2


@pytest.mark.parametrize("algorithm,extra", [
    ("AbsRS", []), ("FIR", ["-t", "5"]),
    ("FIR", ["-t", "5", "--fir-twopass", "2"])],
    ids=["AbsRS", "FIR", "FIR-twopass2"])
def test_profile(algorithm, extra, tmp_path, capsys, monkeypatch):
    argv = ["profile", "-a", algorithm, "--channels", "64", "--ticks", "64",
            "--windows", "2", "--tc", "32", "--k-slots", "2", "-o", "trace",
            "--top", "3"] + extra
    res = {}
    for name, main, dev in (("jax", jcli.main, False),
                            ("port", cli.main, True)):
        res[name] = _run(main, argv, tmp_path / name, capsys, monkeypatch,
                         dev)
    (rc, lines), (jrc, jlines) = res["port"], res["jax"]
    assert rc == jrc == 0
    rep, jrep = lines[0], jlines[0]
    assert set(rep) == set(jrep)
    assert rep["backend"] == "cpu"
    for k in set(jrep) - {"backend", "note"}:
        assert rep[k] == jrep[k], k
    assert (tmp_path / "port" / "trace" / "trace.json").is_file()
    assert lines[1] == "# top ops by total device/host time"
    assert len(lines) == 2 + 1 + 3


# ---- what the commands run on ---------------------------------------------

def test_patterns_match_jax():
    for name, fn in patterns.PATTERNS.items():
        for kw in ({}, {"n_frames": 3, "channel": 9, "pedestal": 700}):
            np.testing.assert_array_equal(fn(**kw),
                                          jpatterns.PATTERNS[name](**kw))
        frames, adcs = patterns.pattern_frames(name, first_timestamp=77,
                                               crate_id=1, stream_id=4)
        jframes, jadcs = jpatterns.pattern_frames(name, first_timestamp=77,
                                                  crate_id=1, stream_id=4)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(adcs, jadcs)
    assert patterns.GOLDEN_THRESHOLD == jpatterns.GOLDEN_THRESHOLD


def test_emulator_files_and_replay_match_jax(tmp_path):
    for mod, d in ((emulator, "port"), (jemulator, "jax")):
        (tmp_path / d).mkdir()
        mod.all_zeros_wibeth_file(tmp_path / d / "z.bin", n_frames=5)
        mod.pattern_file(tmp_path / d / "p.bin", "edge_left", n_frames=2,
                         channel=3, offset=2, first_timestamp=1234)
    for f in ("z.bin", "p.bin"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    payloads = emulator.FileSourceBuffer(wibeth.FRAME_SIZE).read(
        tmp_path / "port" / "z.bin")
    got = {}
    for name, mod, sink, adapter in (
            ("port", emulator, QueueSender(), get_adapter("wibeth")),
            ("jax", jemulator, JQueueSender(), jget_adapter("wibeth"))):
        emu = mod.SourceEmulator(sink, adapter=adapter)
        emu.conf({"rate_hz": 1e6, "batch_size": 3})
        emu.run(payloads.copy(), n_batches=4, first_timestamp=7000,
                tick_per_payload=2048)
        got[name] = (np.concatenate(sink.drain()), emu.packets_sent,
                     emu.packets_dropped)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1:] == got["jax"][1:] == (12, 0)
    (tmp_path / "short.bin").write_bytes(b"\0" * 10)
    for mod in (emulator, jemulator):
        with pytest.raises(ValueError):
            mod.FileSourceBuffer(wibeth.FRAME_SIZE).read(tmp_path /
                                                         "short.bin")


def test_channel_map_tools_match_jax(tmp_path):
    geo, jgeo = channel_map.HDAPAChannelMap(), jchannel_map.HDAPAChannelMap()
    ident = channel_map.IdentityChannelMap()
    jident = jchannel_map.IdentityChannelMap()
    keys = [(0, s, st) for s in range(3) for st in range(4)]
    assert channel_map.cross_check_maps(geo, ident, keys) == \
        jchannel_map.cross_check_maps(jgeo, jident, keys)
    assert channel_map.cross_check_maps(geo, geo, keys)["match"]
    n = channel_map.write_detchannelmaps_dump(geo, tmp_path / "a.txt",
                                              crate=1, header="x\n\ny")
    jn = jchannel_map.write_detchannelmaps_dump(jgeo, tmp_path / "b.txt",
                                                crate=1, header="x\n\ny")
    assert n == jn == 2560
    assert (tmp_path / "a.txt").read_bytes() == \
        (tmp_path / "b.txt").read_bytes()
    for args in ((0, 2, 3), (1, 4, 7)):
        np.testing.assert_array_equal(
            channel_map.register_map_via_expansion(geo, *args),
            jchannel_map.register_map_via_expansion(jgeo, *args))
