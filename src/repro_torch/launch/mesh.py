"""Production mesh definitions (NVIDIA H100 target).  Counterpart of
``repro.launch.mesh``.

The meshes keep JAX's shapes and axis names (16×16 ``("data", "model")``;
2×16×16 ``("pod", "data", "model")``), so every placement can be held
against JAX's rules.  They are ``DeviceMesh``\\ es over the process group
that the caller opened: :func:`fabricate_world` opens a fake one of n ranks
(the counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count``),
and only the dry run and its tests call it.  Importing this module touches
no process group, as JAX's touches no device state.

:class:`MeshSpec` is a mesh's axis names and sizes alone: the sharding
rules (``launch/sharding.py``) read nothing else, so they run on it
without a process group.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch.distributed as dist

# --- hardware constants: NVIDIA H100 SXM5 80GB data sheet, 700 W -------------
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s a direction (900 GB/s both)
HBM_PER_CHIP = 80e9             # bytes of HBM3 per card

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


class MeshSpec(NamedTuple):
    """A mesh's axis names and sizes, without devices or ranks."""
    axis_names: tuple
    shape: tuple


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(MULTI_POD_AXES, (2, 16, 16))
    return MeshSpec(AXES, (16, 16))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshSpec`."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fabricate_world(n: int) -> None:
    """Open a fake process group of ``n`` ranks (this process is rank 0):
    collectives return at once and move no bytes, so a ``DeviceMesh`` of n
    ranks can be built on one host.  Reuses an open fake world of the same
    size; refuses any other open process group."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks "
            f"({dist.get_backend()}) is open; close it first")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the open process
    group (its world size must be the mesh's size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    spec = production_mesh_spec(multi_pod=multi_pod)
    return make_mesh(spec.shape, spec.axis_names, device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel (client) axes of a mesh."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def num_clients(mesh) -> int:
    """Virtual FL clients = product of data-parallel axis sizes."""
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in dp_axes(mesh)))
