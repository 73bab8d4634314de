"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that ``ctypes``
loads — no PyTorch headers, so a build takes seconds.  Libraries go to
``fdreadoutlibs_tpu_torch/_build/`` (gitignored) at first use, under a file
name keyed on a hash of the sources and flags, so an edited source or flag
rebuilds and a stale library is never loaded.

Only the CUDA path calls :func:`load`; importing this module needs no
compiler and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, spills) of each library built by this
# process, by kernel source name
build_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built at first use on a machine with the CUDA toolkit")
    return path


def keyed_path(stem: str, sources, flags) -> Path:
    """``_build/lib<stem>_<hash>.so``, keyed on the sources' names and
    contents and on the flags (shared with the host library of
    ``native/``)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed on the
    contents of every source under csrc/ and on the flags."""
    return keyed_path(name, CSRC_DIR.glob("*.cu*"), NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    build_log[name] = res.stderr
    os.replace(tmp, out)               # atomic: readers never see a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the kernel library."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
