"""Host device mesh (port of `repro.launch.mesh.make_host_mesh`).

A mesh here is a grid of `torch.device`s with the reference's axis names
("data", "model"); serving (`serve.runtime.placement`) flattens it into
one worker per device.  The production meshes of the reference (256 and
512 chips, `make_production_mesh`) wait for the sharded paths.

A function, not a module constant: importing this module never touches
device state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A (data, model) grid of devices."""
    devices: np.ndarray                     # (data, model) of torch.device
    axis_names: tuple = ("data", "model")


def make_host_mesh(model: int = 1, data: int | None = None,
                   device=None) -> HostMesh:
    """Small mesh over whatever devices exist (tests / examples).

    `device=None` (or "cuda" without an index) spans every CUDA device and
    raises without one; an indexed CUDA device spans that device alone;
    "cpu" one CPU device, as a JAX CPU host has.

    The factorization is validated up front: `model` larger than the
    device count used to silently derive a 0-sized data axis
    (`data = n // model`), surfacing later as an opaque mesh-shape error.
    """
    dev = resolve_device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" and dev.index is None else [dev])
    n = len(devices)
    if model < 1:
        raise ValueError(f"make_host_mesh: model={model}; axis sizes must "
                         f"be >= 1")
    if model > n:
        raise ValueError(
            f"make_host_mesh: model={model} exceeds the {n} available "
            f"device(s) -- the derived data axis n // model would be "
            f"zero-sized.  Shrink model or run on more devices.")
    if data is None:
        data = n // model
    if data < 1:
        raise ValueError(f"make_host_mesh: data={data}; axis sizes must "
                         f"be >= 1")
    if data * model > n:
        raise ValueError(
            f"make_host_mesh: a ({data}, {model}) mesh needs "
            f"{data * model} devices but only {n} exist")
    grid = np.empty((data, model), object)
    for i, d in enumerate(devices[:data * model]):
        grid[i // model, i % model] = d
    return HostMesh(devices=grid)
