"""Device meshes of the port: named grids of ``torch.device``s.

A ``Mesh`` is the port's counterpart of ``jax.sharding.Mesh`` for what
the serving engine needs of one: a grid of devices with named axes
(``devices[r, k]``, ``axis_names``) and a ``shape`` mapping from axis
name to extent.  Functions, not module-level constants: importing this
module never touches device state.  A single pod is 16 x 16 (256
devices), multi-pod adds a leading ``pod`` axis (2 pods = 512 devices).

Every mesh function checks the requested shape against the devices that are
actually visible before it builds the grid, and the error says how many
are needed and how many are visible.  Where the host has fewer devices
than the mesh, a caller may pass an explicit device list that repeats a
device (``make_host_mesh(2, 4, devices=["cuda:0"] * 8)``, or eight CPU
slots in the tests): the port's counterpart of XLA's forced host device
count, so a (2, 4) mesh runs on one card.  A repeated device is only
ever the caller's choice, never a quiet fallback.

``device_mesh`` turns a ``Mesh`` into the
``torch.distributed.device_mesh.DeviceMesh`` that the sharded steps lay
DTensors on: one process (rank) per device.  ``fake_world`` opens a
process group of ``n`` ranks in one process on torch's ``fake``
backend, whose collectives move nothing: the dry run traces a pod's
step on it as rank 0 of 256 or 512.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """A grid of ``torch.device``s with named axes.

    ``devices`` is a numpy object array of ``torch.device`` with one
    dimension per name of ``axis_names``; ``shape`` maps each axis name
    to its extent, in order, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh devices have {grid.ndim} axes, "
                             f"names {tuple(axis_names)}")
        self.devices = np.vectorize(resolve_device, otypes=[object])(grid)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def visible_devices(platform: str = "cuda") -> list[torch.device]:
    """The devices a mesh over ``platform`` may use: every visible CUDA
    card, or the one CPU device."""
    if platform == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh over platform {platform!r}; "
                     f"choose cuda or cpu")


def _require_devices(shape: tuple[int, ...], axes: tuple[str, ...],
                     have: int):
    """Fail fast, and usefully, when the host cannot back the mesh."""
    need = math.prod(shape)
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} devices but only "
            f"{have} {'is' if have == 1 else 'are'} visible. Pass an "
            f"explicit list of {need} devices (devices=[...], which may "
            f"repeat a device) to simulate the mesh, or shrink the "
            f"requested shape.")


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices,
          platform: str) -> Mesh:
    if devices is None:
        have = visible_devices(platform)
        _require_devices(shape, axes, len(have))
        devices = have[:math.prod(shape)]
    elif len(devices) != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} devices, got {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return Mesh(grid.reshape(shape), axes)


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the pod mesh: 16 x 16, or 2 x 16 x 16."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The pod mesh over the visible CUDA cards; raises on fewer."""
    return _mesh(*production_shape(multi_pod), None, "cuda")


def device_mesh(mesh: Mesh):
    """``mesh`` as a ``DeviceMesh`` with the same axis names: rank r of
    the initialised process group runs on ``mesh.devices.flat[r]``, so
    the group must have one rank per device of the mesh.  A mesh that
    repeats a CUDA device is refused: NCCL cannot place two ranks on one
    card (the CPU may hold several ranks, one process each, on gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    flat = list(mesh.devices.reshape(-1))
    kinds = {d.type for d in flat}
    if len(kinds) != 1:
        raise ValueError(f"mesh mixes device kinds {sorted(kinds)}")
    kind = kinds.pop()
    cards = [d for d in flat if d.type == "cuda"]
    if len(set(cards)) != len(cards):
        raise ValueError(
            f"{mesh} repeats a CUDA device: a DeviceMesh has one rank per "
            f"device and NCCL cannot place two ranks on one card; give "
            f"each rank its own card")
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group) with one "
                           "rank per device of the mesh")
    if dist.get_world_size() != len(flat):
        raise ValueError(f"{mesh} has {len(flat)} devices but the process "
                         f"group has {dist.get_world_size()} ranks")
    if kind == "cuda":
        torch.cuda.set_device(flat[dist.get_rank()])
    ranks = torch.arange(len(flat)).reshape(mesh.devices.shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in this process, this process rank
    0, on the ``fake`` backend (collectives return at once and move
    nothing): enough to lay DTensors of a 256- or 512-device mesh on
    ``meta`` tensors and count their collectives.  The backend comes
    from ``torch.testing._internal.distributed.fake_pg``, a module that
    torch keeps internal (no stability promise); this is the port's only
    import of it.  The group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(data: int = 1, model: int = 1, devices=None,
                   platform: str = "cuda") -> Mesh:
    """Small ``(data, model)`` mesh (the serving engine's ``--mesh``).

    With ``devices=None`` it takes the first ``data * model`` visible
    devices of ``platform`` (the CUDA cards, or the one CPU device) and
    raises when there are fewer; ``devices`` names the grid's devices
    explicitly, row by row, and may repeat one."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"data={data} model={model}")
    return _mesh((data, model), ("data", "model"), devices, platform)
