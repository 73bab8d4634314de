"""The port's CUDA kernel libraries built for the CPU tests: every
translation unit of ``csrc/<name>*.cu`` compiled at once with the host C++
compiler against the stand-in CUDA runtime (``tests/cuda_host/``,
``-DTPG_HOST_EMULATION``), as ``ops/_build.py`` compiles them with nvcc,
and linked, with the same defines (a pipeline geometry of its own,
``ops/tpg.py::geometry_defines``).  The library lands in
``fdreadoutlibs_tpu_torch/_build/`` (gitignored) under a name keyed on its
sources, the stand-in, the flags and the defines, behind a file lock, so the test files that load it build it once
between them (each worker process waits for the one that builds)."""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import pytest

from fdreadoutlibs_tpu_torch.ops import _build

STUB = Path(__file__).resolve().parent / "cuda_host"
FLAGS = ("-std=c++17", "-O1", "-fPIC", "-pthread", "-x", "c++",
         "-DTPG_HOST_EMULATION")


def host_library(name: str, defines=()) -> ctypes.CDLL:
    """Build (unless its keyed file exists) and load the host library of
    kernel library ``name`` with ``defines``; skips without a host C++
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    flags = FLAGS + _build.define_flags(defines)
    out = _build.keyed_path(f"{name}_host",
                            _build.sources(name) + sorted(STUB.glob("*.h")),
                            (cxx,) + flags)
    out.parent.mkdir(exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            with tempfile.TemporaryDirectory(prefix=f"{name}_host_",
                                             dir=out.parent) as tmp:
                objs, _ = _build.compile_units(
                    lambda src, obj: [cxx, *flags, f"-I{STUB}", "-c", "-o",
                                      str(obj), str(src)],
                    _build.units(name), Path(tmp))
                part = Path(tmp) / out.name
                res = subprocess.run([cxx, "-shared", "-pthread", "-o",
                                      str(part), *map(str, objs)],
                                     capture_output=True, text=True)
                assert res.returncode == 0, res.stderr
                os.replace(part, out)
    return ctypes.CDLL(str(out))
