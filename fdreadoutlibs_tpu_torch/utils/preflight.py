"""Device preflight — counterpart of ``fdreadoutlibs_tpu/utils/preflight.py``.

Every hardware script calls :func:`device_preflight` first, so a run on the
wrong card (or on none) costs seconds and ends in an error that carries the
versions.  The original guards against a libtpu client/terminal version
skew; that failure does not exist here and none of its logic is carried
over.  What can go wrong here: no CUDA device, a card that is not Hopper
(the kernels are built for ``sm_90a`` only), a driver that cannot run a
first transfer.

:func:`nvidia_smi` and :func:`sm_clock_mhz` read the card's name, power limit
and SM clock; a card may be set below its maximum power and then runs slower
under load, so every kept number stands beside them.
"""

from __future__ import annotations

import json
import subprocess

import torch

CAPABILITY = (9, 0)           # the kernels are built for sm_90a


def _smi(query: str, units: bool = True) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def nvidia_smi() -> str:
    """The first card's ``name, power.limit`` line as ``nvidia-smi`` prints
    it."""
    return _smi("name,power.limit")


def sm_clock_mhz() -> float:
    """The card's SM clock now (right after a timing loop), in MHz."""
    return float(_smi("clocks.sm", units=False))


def backend_versions() -> dict:
    """The version facts of this installation and its first card (cheap: no
    kernel runs).  Keys that need a card or ``nvidia-smi`` are left out
    where there is none."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
        info["count"] = torch.cuda.device_count()
        try:
            info["driver"] = _smi("driver_version")
            info["nvidia_smi"] = nvidia_smi()
        except (OSError, subprocess.SubprocessError, IndexError):
            pass
    return info


def device_preflight(device=None, raise_on_error: bool = True) -> dict:
    """One tiny transfer and sum on ``device`` (default: the first card);
    returns the version dict with ``ok`` on success.  A CUDA device whose
    capability is not (9, 0) is refused.  On failure, raise (or return, with
    ``raise_on_error=False``) a RuntimeError whose message carries the
    versions.  A CPU device passes the transfer check only: the caller asked
    for the plain versions."""
    info = backend_versions()
    try:
        dev = torch.device("cuda", 0) if device is None \
            else torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("torch finds no CUDA device")
            cap = torch.cuda.get_device_capability(dev)
            if cap != CAPABILITY:
                raise RuntimeError(
                    f"the kernels are built for sm_90a; this card is "
                    f"capability {cap}")
        total = int(torch.arange(8, dtype=torch.int32).to(dev).sum())
        if total != 28:
            raise RuntimeError(f"preflight compute wrong: {total} != 28")
        info["ok"] = True
        return info
    except Exception as e:  # noqa: BLE001 — every failure mode must report
        msg = str(e)
        err = RuntimeError(
            f"device preflight failed: "
            f"{msg.splitlines()[-1] if msg else repr(e)}\n"
            f"versions: {json.dumps(info)}")
        if raise_on_error:
            raise err from e
        info["ok"] = False
        info["error"] = str(err)
        return info
