"""The readers of the app's stage spans, each fed a synthetic record: the
value it returns, and None where the rows lack its key (a program
without the span) or there are no rows."""

import pytest

from tpgbench import spec
from tpgbench.metrics._spans import HOST_SPANS

BENCH = spec.load_benchmark()

# two rows of a card's window: every host span, the device times, the step
ROWS = [
    {"preprocess_ms": 0.5, "retention_ms": 0.25, "words_ms": 16.0,
     "codec_ms": 8.5, "h2d_host_ms": 7.0, "tpg_launch_ms": 0.125,
     "compact_launch_ms": 1.0, "fetch_ms": 0.5, "assembly_ms": 0.75,
     "handler_ms": 0.25, "tpg_device_ms": 0.5, "compact_device_ms": 0.375,
     "step_ms": 35.5, "total_ms": 80.0},
    {"preprocess_ms": 0.5, "retention_ms": 0.25, "words_ms": 18.0,
     "codec_ms": 8.5, "h2d_host_ms": 8.0, "tpg_launch_ms": 0.375,
     "compact_launch_ms": 1.5, "fetch_ms": 1.5, "assembly_ms": 0.75,
     "handler_ms": 0.25, "tpg_device_ms": 0.25, "compact_device_ms": 0.625,
     "step_ms": 40.0, "total_ms": 82.0},
]
# the named spans sum to 34.875 and 39.625
WANT = {"words_ms": 17.0, "h2d_host_ms": 7.5, "launch_ms": 1.5,
        "fetch_ms": 1.0, "tpg_device_ms": 0.375, "compact_device_ms": 0.5,
        "host_unnamed_ms": 0.5}
# the keys each reader needs; removing any one gives None
NEEDS = {"words_ms": ["words_ms"], "h2d_host_ms": ["h2d_host_ms"],
         "launch_ms": ["tpg_launch_ms", "compact_launch_ms"],
         "fetch_ms": ["fetch_ms"], "tpg_device_ms": ["tpg_device_ms"],
         "compact_device_ms": ["compact_device_ms"],
         "host_unnamed_ms": ["step_ms", *HOST_SPANS]}


def record(rows):
    return {"batch_timings": rows, "trace": None, "delivered": len(rows)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    assert spec.reader(name)(record(ROWS)) == pytest.approx(WANT[name],
                                                            abs=1e-12)


@pytest.mark.parametrize("name,key", [(n, k) for n in sorted(NEEDS)
                                      for k in NEEDS[n]])
def test_reader_none_without_its_key(name, key):
    rows = [dict(r) for r in ROWS]
    del rows[1][key]
    assert spec.reader(name)(record(rows)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_rows(name):
    assert spec.reader(name)(record([])) is None
    assert spec.reader(name)({"trace": None}) is None


def test_parent_rows_read_none():
    """The rows of the app before the spans: the kept keys and
    ``device_ms``; every new reader is silent, the kept ones still read."""
    old = [{"preprocess_ms": 0.5, "retention_ms": 0.25, "codec_ms": 8.5,
            "device_ms": 1.0, "assembly_ms": 0.75, "handler_ms": 0.25,
            "total_ms": 80.0}]
    for name in WANT:
        assert spec.reader(name)(record(old)) is None, name
    assert spec.reader("codec_ms")(record(old)) == 8.5


def test_cpu_rows_leave_the_device_readers_silent():
    cpu = [{k: v for k, v in r.items() if not k.endswith("_device_ms")}
           for r in ROWS]
    for name in WANT:
        got = spec.reader(name)(record(cpu))
        assert (got is None) == name.endswith("_device_ms"), name


def test_entries_read_the_spans():
    """Each new metric is a program span moving ``rtf`` in the cell its
    rows come from."""
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    for name in WANT:
        m = by_name[name]
        assert (m["source"], m["moves"], m["unit"]) == \
            ("program_span", "rtf", "ms")
        assert m["workloads"] == ["hd_apa_wibeth.nominal"]
