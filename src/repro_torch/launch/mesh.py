"""The production mesh as a plain description (port of
``repro/launch/mesh.py``).

JAX's mesh holds devices, and its dry-run lowers for 512 fake ones.  The
port's dry-run builds on the ``meta`` device and needs only the axes'
names and sizes: the shardings read them (``launch/shardings``) and the
model takes the ``model`` axis as its expert-parallel degree
(``launch/dryrun``).  ``torch.distributed.device_mesh`` needs one process
a device, and the port's ranks already run through ``core/dispatch``'s
communicators, so a ``Mesh`` here is a frozen description with no devices
and no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_mesh(shape, axes) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return Mesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``data x model`` mesh (tests, and the chip's 1 x 1)."""
    return make_mesh((data, model), ("data", "model"))


def mesh_axis_sizes(mesh: Mesh) -> Tuple[Tuple[str, int], ...]:
    return tuple(zip(mesh.axis_names, mesh.shape))
