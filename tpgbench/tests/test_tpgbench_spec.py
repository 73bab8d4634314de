"""Every configuration, traffic mix and metric is a file found by name;
one more of each, added as new files and entries, makes a new cell with
no edit to a file that is there."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from tpgbench import spec

from conftest import ROOT

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_loads(name):
    cfg = spec.configuration(BENCH, name)
    mod = spec.system(cfg["system"])
    assert mod.n_apas(cfg) >= 1 and hasattr(mod, "System")


@pytest.mark.parametrize("name", sorted({w["traffic"]
                                         for w in BENCH["workloads"]}))
def test_traffic_loads(name):
    t = spec.traffic(name)
    assert hasattr(spec.generator(t["generator"]), "Source")
    assert t["loop"] == "saturating" and t["frames_per_batch"] > 0


@pytest.mark.parametrize("name", [m["name"] for m in
                                  BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads(name):
    assert callable(spec.reader(name))


def test_a_dotted_name_reads_with_its_stem():
    assert spec.reader("codec_ms.burst") is spec.reader("codec_ms")


def test_every_cell_reports_its_metrics():
    for w in BENCH["workloads"]:
        e2e = spec.metrics_of(BENCH, w["name"], False)
        layers = spec.metrics_of(BENCH, w["name"], True)
        assert {m["name"] for m in e2e} >= {"rtf", "setup_s"}
        assert layers


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


ADDED = {
    "configs/hd_apa_wibeth_small.json": None,      # written below
    "traffic/quiet.json": {
        "generator": "wibeth_slabs", "loop": "saturating", "frames_per_batch": 16, "pedestal": 900,
        "noise_sigma": 30, "pulse_rate_per_channel_frame": 0.0,
        "pulse_adc": [300, 3000], "pulse_ticks": 8, "pulse_start_ticks": 50},
    "metrics/batches_delivered.py":
        '"""batches_delivered: APA-batches delivered in the window."""\n\n\n'
        'def read(run):\n    return float(run["delivered"])\n',
}


def test_new_cell_from_new_files_only(tmp_path):
    pkg = tmp_path / "tpgbench"
    shutil.copytree(ROOT / "tpgbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(pkg)
    small = json.loads((pkg / "configs/hd_apa_wibeth.json").read_text())
    small.update(name="hd_apa_wibeth_small", links=2,
                 raw_capacity_frames=64)
    for rel, body in ADDED.items():
        body = small if body is None else body
        (pkg / rel).write_text(body if isinstance(body, str)
                               else json.dumps(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hd_apa_wibeth_small",
                             "source": "test", "reduced": ["links"],
                             "file": "tpgbench/configs/"
                                     "hd_apa_wibeth_small.json",
                             "why": "test"})
    bench["workloads"].append({"name": "hd_apa_wibeth_small.quiet",
                               "config": "hd_apa_wibeth_small",
                               "traffic": "quiet", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "batches_delivered",
                                "unit": "batches", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["hd_apa_wibeth_small.quiet"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(pkg)
    assert all(after[p] == d for p, d in before.items())
    code = (
        "import argparse, json, sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "sys.path.insert(0, '.')\n"
        "from tpgbench import harness, spec\n"
        "assert spec.PKG.parent.resolve() == __import__('pathlib')"
        ".Path('.').resolve()\n"
        "bench = spec.load_benchmark()\n"
        "a = argparse.Namespace(workload='hd_apa_wibeth_small.quiet', "
        "seed=9, seconds=4, trace=0)\n"
        "print(json.dumps(harness.run_cell(bench, a, torch.device('cpu'), "
        "time.monotonic())))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"rtf", "setup_s", "batches_delivered"}
