"""Meshes of the port: ``torch.distributed`` device meshes over one process
per device.

Single pod: axes ``('data', 'model')``. Multi-pod: ``('pod', 'data',
'model')``: the ``pod`` axis composes with ``data`` for batch and buffer
sharding, so the data-parallel workers span pods, and the rehearsal
exchange chooses whether to cross pods (``exchange='full'``) or stay inside
one (``'pod_local'``: over the innermost ``data`` sub-group).

A ``pipe`` axis carries the GPipe schedule of ``parallel.pipeline``: its
ranks hold the stages of one layer stack, ``mesh.get_group("pipe")`` their
group (``make_mesh((4,), ("pipe",))``, as the reference's test builds it).

The ``model`` axis carries tensor parallelism (``parallel.tensor``): the M
ranks of a row hold the shards of one model and the same rehearsal buffer.
``parallel.model_parallel(mesh)`` is their handle, ``parallel.dp_group``
the data-parallel ranks of a rank's model column (the group its gradients,
loss and exchange are summed over), which ``make_mesh`` makes.

A mesh of one worker needs no process group: without one, ``make_mesh``
returns a ``SingleDeviceMesh`` (the exchange over it is the identity).
Otherwise every rank of the default group calls ``make_mesh`` with the same
arguments, and the mesh covers the group, rank ``i`` at row-major position
``i`` (``pod`` major, ``model`` minor).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import make_column_groups, model_axis_size


class SingleDeviceMesh:
    """A mesh of one worker and no process group, with the ``DeviceMesh``
    surface the port reads (``device_type``, ``mesh_dim_names``, ``size``,
    ``get_group``, ``get_coordinate``). ``get_group`` is None: nothing to
    exchange with but itself."""

    def __init__(self, device_type: str, axes: Tuple[str, ...]):
        self.device_type = device_type
        self.mesh_dim_names = tuple(axes)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)

    def __repr__(self) -> str:
        return f"SingleDeviceMesh({self.device_type!r}, {self.mesh_dim_names})"


def _device_type() -> str:
    if dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = None):
    """A mesh of ``shape`` over ``axes`` (``('data', 'model')``,
    ``('pod', 'data', 'model')``, or with a ``pipe`` axis among them).
    ``device_type``: the default group's
    (``cuda`` under NCCL, ``cpu`` under gloo), else ``cuda`` when a card is
    visible."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    unknown = set(axes) - {"pod", "data", "model", "pipe"}
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be distinct names of pod, data, model, pipe: {axes}")
    device_type = device_type or _device_type()
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} workers needs a process group: start one "
                               f"process per worker (torchrun, or runtime.multiproc)")
        return SingleDeviceMesh(device_type, axes)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} has {n} workers but the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    if model_axis_size(mesh) > 1:
        make_column_groups(mesh)
    return mesh


def make_production_mesh(multi_pod: bool = False, device_type: str = None):
    """The reference's production layouts: ``(16, 16)`` over ``('data',
    'model')``, or ``(2, 16, 16)`` over ``('pod', 'data', 'model')``. A
    process group of 256 (512) ranks is needed, as for any mesh."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)


def memory_kinds(mesh) -> set:
    """Memory kinds a rank of ``mesh`` can place the tiered store in:
    ``{'device', 'pinned_host'}`` on CUDA (the cold tier's pinned host
    memory), ``{'device'}`` on the CPU, whose device memory is the host's."""
    return {"device", "pinned_host"} if mesh.device_type == "cuda" else {"device"}


def describe(mesh) -> str:
    """``'data=2 x model=1'``: each axis and its size, in the mesh's order."""
    return " x ".join(f"{a}={mesh.size(i)}" for i, a in enumerate(mesh.mesh_dim_names))
