"""Meshes of devices for link-axis sharding.

Counterpart of ``fdreadoutlibs_tpu/parallel/mesh.py:10-58``.  A
:class:`LinkMesh` is an ndarray of ``torch.device`` objects with the axis
names of the JAX ``Mesh`` (``("link",)`` or ``("apa", "link")``), so
``mesh.devices.shape`` and ``mesh.devices.size`` read as they do there.

The JAX helpers fall back to the virtual CPU device pool when the default
backend has too few devices (:19-26, :49-53).  These do not fall back: by
default a mesh spans the visible CUDA cards, and asking for more shards
than cards raises.  Naming a device (``device="cuda:0"`` or ``"cpu"``) puts
every shard on that one device instead, the counterpart of
``--xla_force_host_platform_device_count``: the shards still run apart,
each on its own CUDA stream on a card, or one after another on the CPU
(the plain versions).

:class:`Sharded` is an array split over a mesh: one tensor a shard, each on
its shard's device.  ``np.asarray`` gathers it on the host, as
``np.asarray`` gathers a sharded JAX array.
"""

from __future__ import annotations

import numpy as np
import torch


class LinkMesh:
    """Devices on named axes: ``devices`` is an object ndarray of
    ``torch.device``, ``axis_names`` names its axes."""

    def __init__(self, devices, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _devices(n: int | None, device) -> list:
    """n devices: ``device`` n times when it is named, else the first n
    visible CUDA cards (every card when n is None); raises when there are
    too few."""
    if device is not None:
        from ..apps.apa_readout import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * (1 if n is None else n)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is visible; name one to put every "
                           "shard on it (device='cuda:0' or device='cpu')")
    n = count if n is None else n
    if n > count:
        raise ValueError(f"need {n} devices, have {count} CUDA cards; name "
                         "a device to put the shards on one "
                         "(device='cuda:0' or device='cpu')")
    return [torch.device("cuda", i) for i in range(n)]


def make_link_mesh(n_devices: int | None = None, device=None) -> LinkMesh:
    """1-D mesh over the 'link' axis (links = DUNE readout streams): the
    first ``n_devices`` CUDA cards (all of them when None), or
    ``n_devices`` shards on ``device``."""
    return LinkMesh(_devices(n_devices, device), ("link",))


def make_apa_link_mesh(n_apas: int, n_link_shards: int | None = None,
                       device=None) -> LinkMesh:
    """2-D ('apa', 'link') mesh: one contiguous device group per APA
    (detector scale-out; ``DetectorPipeline``).  ``n_link_shards`` defaults
    to (visible cards) // n_apas, or 1 on a named device."""
    if n_link_shards is None:
        n_link_shards = 1 if device is not None else max(
            1, (torch.cuda.device_count() if torch.cuda.is_available()
                else 0) // n_apas)
    need = n_apas * n_link_shards
    try:
        devs = _devices(need, device)
    except ValueError as e:
        raise ValueError(f"need {need} devices ({n_apas} APAs x "
                         f"{n_link_shards}): {e}") from None
    return LinkMesh(np.array(devs, dtype=object).reshape(n_apas,
                                                         n_link_shards),
                    ("apa", "link"))


class Sharded:
    """An array split over a mesh's grid of shards: ``shards`` is an object
    ndarray of tensors (``tensors`` in row-major grid order), one a grid
    cell, each on its device; grid axis i splits array axis i.
    ``np.asarray`` (and indexing, which gathers first) gives the whole
    array on the host."""

    def __init__(self, tensors, grid_shape: tuple | None = None):
        tensors = list(tensors)
        self.shards = np.empty(grid_shape or (len(tensors),), dtype=object)
        if self.shards.size != len(tensors):
            raise ValueError(f"{len(tensors)} shards for a grid of "
                             f"{self.shards.shape}")
        for i, t in enumerate(tensors):
            self.shards.flat[i] = t

    @property
    def shape(self) -> tuple:
        first = self.shards.flat[0]
        shape = list(first.shape)
        for ax, n in enumerate(self.shards.shape):
            idx = [0] * self.shards.ndim
            shape[ax] = 0
            for i in range(n):
                idx[ax] = i
                shape[ax] += self.shards[tuple(idx)].shape[ax]
        return tuple(shape)

    @property
    def dtype(self):
        return self.shards.flat[0].dtype

    def numpy(self) -> np.ndarray:
        """The whole array on the host: the shards joined on the first
        shard's device, then one copy to the host."""
        dev = self.shards.flat[0].device

        def join(grid, ax):
            return torch.cat([join(g, ax + 1) if grid.ndim > 1 else g.to(dev)
                              for g in grid], dim=ax)

        return join(self.shards, 0).cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __len__(self) -> int:
        return self.shape[0]
