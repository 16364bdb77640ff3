"""Process-group meshes — the port of ``byteps_tpu/parallel/mesh.py``.

JAX lays its devices out as a named mesh and reduces over mesh axes.
The port keeps the reference's process model, one process per GPU: a
*worker* is a rank of ``torch.distributed``, and a mesh names axes over
the ranks, row-major in the JAX package's canonical axis order (``dcn``
outermost).  Each axis gets one process group per line of ranks along
it, so a reduce over an axis is a collective on this rank's group of
that axis.

Only the data axes (``dcn``, ``dp``, ``fsdp``) are ported; a
model-parallel axis (``tp``, ``sp``, ``pp``, ``ep``) is refused until
the port's model-parallel slice (queue A item 12).
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

# Canonical axis order: outermost (slowest) to innermost (fastest).
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")
DATA_AXES = ("dcn", "dp", "fsdp")


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse ``BYTEPS_MESH_SHAPE``-style strings, e.g. ``"dcn=2,dp=4"``."""
    out: Dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {name!r}; valid: "
                             f"{AXIS_ORDER}")
        if name not in DATA_AXES:
            raise NotImplementedError(
                f"mesh axis {name!r} is model parallelism, which the port "
                f"does not have yet (queue A item 12); data axes only: "
                f"{DATA_AXES}")
        out[name] = int(val)
    return out


class ProcessMesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis -> size in canonical order; rank ``r`` sits at the
    row-major coordinates of ``r`` (the JAX package's
    ``np.reshape(devices, dims)``).  ``group(axis)`` is this rank's
    process group along ``axis``; ``group(None)`` spans every axis (the
    whole world)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Dict[Optional[str], object]):
        self.shape = collections.OrderedDict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.rank = rank
        self._groups = groups

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        r = self.rank if rank is None else rank
        out = []
        for s in reversed(list(self.shape.values())):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    def group(self, axis: Optional[str] = None):
        if axis is not None and axis not in self.shape:
            raise ValueError(f"axis {axis!r} is not in the mesh "
                             f"{dict(self.shape)}")
        return self._groups[axis]

    def groups(self, axes: Sequence[str]) -> List[object]:
        return [self.group(a) for a in axes]


def _lines(shape: Dict[str, int], axis: str) -> List[List[int]]:
    """Every line of ranks along ``axis`` (the other coordinates fixed),
    in a fixed order: the groups every rank must create alike."""
    names = list(shape)
    dims = [shape[a] for a in names]
    k = names.index(axis)
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    others = [range(d) if i != k else range(1) for i, d in enumerate(dims)]
    lines = []
    for base in itertools.product(*others):
        start = sum(c * s for c, s in zip(base, strides))
        lines.append([start + j * strides[k] for j in range(dims[k])])
    return lines


def mesh_shape_for(world: int, mesh_shape: Optional[Dict[str, int]] = None,
                   data_axis: str = "dp",
                   force_distributed: bool = False) -> Dict[str, int]:
    """The JAX package's ``build_mesh`` sizing over ``world`` workers:
    ``mesh_shape`` axes in canonical order with the remainder on
    ``data_axis``; by default all on ``data_axis``, or with
    ``force_distributed`` (``BYTEPS_FORCE_DISTRIBUTED``) a ``dcn`` axis of
    2 over the rest."""
    shape: Dict[str, int] = collections.OrderedDict()
    if mesh_shape:
        parse_mesh_shape(",".join(f"{k}={v}" for k, v in mesh_shape.items()))
        for ax in AXIS_ORDER:
            if ax in mesh_shape:
                shape[ax] = int(mesh_shape[ax])
        given = 1
        for v in shape.values():
            given *= v
        if world % given != 0:
            raise ValueError(f"mesh shape {dict(shape)} does not divide "
                             f"the world of {world}")
        if given != world:
            if data_axis in shape:
                raise ValueError(f"mesh shape {dict(shape)} covers "
                                 f"{given} workers, have {world}")
            shape[data_axis] = world // given
            shape = collections.OrderedDict(
                (ax, shape[ax]) for ax in AXIS_ORDER if ax in shape)
    elif force_distributed and world % 2 == 0 and world > 1:
        shape["dcn"] = 2
        shape[data_axis] = world // 2
    else:
        shape[data_axis] = world
    return shape


def build_mesh(mesh_shape: Optional[Dict[str, int]] = None,
               data_axis: str = "dp", force_distributed: bool = False,
               backend: Optional[str] = None) -> ProcessMesh:
    """The mesh over the initialized default process group, creating
    one group per line of every axis and one over the world (a
    collective call: every rank runs it alike)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = mesh_shape_for(world, mesh_shape, data_axis, force_distributed)
    groups: Dict[Optional[str], object] = {
        None: dist.new_group(list(range(world)), backend=backend)}
    for axis in shape:
        for line in _lines(shape, axis):
            g = dist.new_group(line, backend=backend)
            if rank in line:
                groups[axis] = g
    return ProcessMesh(shape, rank, groups)


def reduce_axes(mesh: ProcessMesh,
                data_axes: Sequence[str] = DATA_AXES) -> List[str]:
    """The mesh axes a gradient allreduce spans, outer to inner."""
    return [ax for ax in data_axes if ax in mesh.axis_names]


def axis_size(mesh: ProcessMesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def world_size(mesh: ProcessMesh,
               data_axes: Sequence[str] = DATA_AXES) -> int:
    s = 1
    for ax in reduce_axes(mesh, data_axes):
        s *= axis_size(mesh, ax)
    return s
