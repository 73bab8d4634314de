"""Build and load the port's hand-written CUDA kernels.

A kernel library ``<name>`` is every ``csrc/<name>*.cu`` translation unit
(with the headers they share) compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per unit, all started together, and linked into one
shared library with a plain C interface that ``ctypes`` loads — no PyTorch
headers, so a unit takes seconds.  Libraries go to
``fdreadoutlibs_tpu_torch/_build/`` (gitignored) at first use, under a file
name keyed on a hash of the sources and flags, so an edited source or flag
rebuilds and a stale library is never loaded.  A library may take
preprocessor defines (the pipeline's geometry, ``ops/tpg.py::
geometry_defines``): each set of defines is a library of its own, keyed on
them too; no define keys as the library always has.

Only the CUDA path calls :func:`load`; importing this module needs no
compiler and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_loaded: dict[tuple, ctypes.CDLL] = {}
# ptxas resource report (registers, spills) of each library built by this
# process, by log_key(name, defines): the kernel library name without
# defines
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


def units(name: str) -> list[Path]:
    """The translation units of kernel library ``name``: csrc/<name>*.cu."""
    found = sorted(CSRC_DIR.glob(f"{name}*.cu"))
    if not found:
        raise FileNotFoundError(f"no csrc/{name}*.cu")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """Every file the library ``name`` is built from: its units and the
    headers under csrc/ that they include, directly or through another."""
    seen = {p.name: p for p in units(name)}
    todo = list(seen.values())
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC_DIR / inc
            if inc not in seen and path.exists():
                seen[inc] = path
                todo.append(path)
    return sorted(seen.values())


def define_flags(defines=()) -> tuple:
    """``-DNAME=value`` for each (name, value) pair, in name order."""
    return tuple(f"-D{k}={v}" for k, v in sorted(defines))


def log_key(name: str, defines=()) -> str:
    """The :data:`build_log` key of library ``name`` built with
    ``defines``: the name alone without defines."""
    return " ".join((name,) + define_flags(defines))


def library_path(name: str, defines=()) -> Path:
    """Where the library ``name`` lives, keyed on the contents of its own
    sources (:func:`sources`), on the flags and on the defines: an edit to
    another library's unit or header rebuilds nothing here, and no define
    keys as before there were defines."""
    return keyed_path(name, sources(name),
                      NVCC_FLAGS + LINK_FLAGS + define_flags(defines))


def compile_units(compile_cmd, sources, out_dir: Path) -> tuple[list, str]:
    """Run ``compile_cmd(src, obj)`` for every source at once, one process
    each, into ``out_dir``.  Returns (objects, the compilers' stderr).
    Raises on the first failure, after every process has ended."""
    procs = []
    try:
        for src in sources:
            obj = out_dir / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                compile_cmd(src, obj), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}{err}")
        if failed:
            raise RuntimeError("compile failed for " + "\n".join(failed))
        return [obj for _, obj, _ in procs], "".join(logs)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build(name: str, defines=()) -> Path:
    """Compile and link the units of ``name`` with ``defines`` unless its
    keyed library exists."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + define_flags(defines)
    with tempfile.TemporaryDirectory(prefix=f"{name}_",
                                     dir=BUILD_DIR) as tmp_dir:
        objs, log = compile_units(
            lambda src, obj: [nvcc, *flags, "-c", "-o", str(obj),
                              str(src)], units(name), Path(tmp_dir))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed for {name}:\n{res.stderr}")
    build_log[log_key(name, defines)] = log
    os.replace(tmp, out)               # atomic: readers never see a partial file
    return out


def sass(name: str) -> str:
    """The machine code (SASS) of every kernel of the built library
    ``name``, as ``cuobjdump -sass`` prints it (the tool ships with the
    CUDA toolkit, beside ``nvcc``)."""
    tool = shutil.which("cuobjdump") or \
        str(Path(_nvcc()).with_name("cuobjdump"))
    res = subprocess.run([tool, "-sass", str(build(name))],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed for {name}:\n"
                           f"{res.stderr}")
    return res.stdout


def load(name: str, defines=()) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the kernel library
    ``name`` with ``defines``."""
    key = (name, tuple(sorted(defines)))
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, defines)))
        _loaded[key] = lib
    return lib
