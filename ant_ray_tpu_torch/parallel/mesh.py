"""Device meshes (counterpart of ant_ray_tpu/parallel/mesh.py).

A mesh is a grid of cells, one ``torch.device`` each, with named axes in
the reference's order ("pp", "dp", "fsdp", "ep", "sp", "tp"): the
bandwidth-hungriest axis innermost, so that on a machine of several cards
it maps to the closest neighbours.  ``mesh.shape`` is a dict of axis
sizes, as in JAX.

Unlike a JAX mesh, cells may repeat a device, but only when the caller
lists them so (``build_mesh(devices=["cuda:0"] * 2, tp=2)``): such a mesh
``is_virtual``, and ``size`` counts cells, not distinct devices.  It runs
every cell's program on the one device, which is how a machine with one
card, or the CPU, runs the code of a mesh.  ``build_mesh()`` without
devices never repeats one: it takes the visible cards, and raises when
there are fewer than the axes need.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


class AxisNames:
    PIPELINE = "pp"
    DATA = "dp"
    FSDP = "fsdp"
    EXPERT = "ep"
    SEQUENCE = "sp"
    TENSOR = "tp"

    ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass
class MeshConfig:
    """Degrees for each parallelism axis; -1 on at most one axis means
    "absorb all remaining devices"."""

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def degrees(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AxisNames.ORDER}

    def resolve(self, n_devices: int) -> "MeshConfig":
        degrees = self.degrees()
        wildcards = [k for k, v in degrees.items() if v == -1]
        if len(wildcards) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in degrees.values() if v != -1)
        if wildcards:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            degrees[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {degrees} needs {fixed} devices, have {n_devices}")
        return MeshConfig(**degrees)


class Mesh:
    """``devices``: an array (or nested list) of devices or device names,
    one per cell; ``axis_names``: one name per array dimension.  Cell
    ``i`` is the ``i``-th entry of the array in C order, and every list
    of per-cell values in ``parallel/`` is indexed so."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{self.axis_names}")
        cells = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, dev in enumerate(cells):
            self.devices.flat[i] = dev
        self.cell_devices = cells
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        """Number of cells."""
        return len(self.cell_devices)

    @property
    def device_set(self) -> set:
        return set(self.cell_devices)

    @property
    def is_virtual(self) -> bool:
        """True when cells repeat a device."""
        return len(self.device_set) < self.size

    def coords(self, cell: int) -> dict[str, int]:
        idx = np.unravel_index(cell, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.cell_devices == other.cell_devices)

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.cell_devices)))

    def __repr__(self):
        virtual = ", virtual" if self.is_virtual else ""
        return (f"Mesh({self.shape}, devices "
                f"{sorted({str(d) for d in self.cell_devices})}{virtual})")


def visible_devices() -> list:
    """The visible CUDA cards, one each."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(config: MeshConfig | None = None, devices=None,
               **axis_degrees) -> Mesh:
    """Build a Mesh with the standard axis order.

    ``build_mesh(dp=2, tp=4)`` or ``build_mesh(MeshConfig(fsdp=-1, tp=4))``
    over the visible cards; ``devices=`` takes the list as given, repeats
    included (a virtual mesh).
    """
    if config is None:
        config = MeshConfig(**axis_degrees)
    elif axis_degrees:
        raise ValueError("pass either MeshConfig or axis kwargs, not both")
    devices = list(devices) if devices is not None else visible_devices()
    config = config.resolve(len(devices))
    degrees = config.degrees()
    shape = tuple(degrees[name] for name in AxisNames.ORDER)
    array = np.empty(len(devices), dtype=object)
    array[:] = [torch.device(d) for d in devices]
    return Mesh(array.reshape(shape), AxisNames.ORDER)


def local_device_mesh(**axis_degrees) -> Mesh:
    """Mesh over this process's visible cards."""
    return build_mesh(devices=visible_devices(), **axis_degrees)


local_chip_mesh = local_device_mesh


def mesh_axis_size(mesh, *names: str) -> int:
    return math.prod(mesh.shape.get(n, 1) for n in names)
