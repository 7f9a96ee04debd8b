"""Mesh construction for single-pod and multi-pod deployments.

PyTorch port of ``repro.launch.mesh``: a JAX ``Mesh`` becomes a
:class:`~torch.distributed.device_mesh.DeviceMesh`, whose ranks lie in
row-major order over its axes.  The caller initializes the process group
first (``torch.distributed.init_process_group``: NCCL on the card, gloo on
the CPU); these functions raise without one instead of starting one from
the environment.  Functions, not module-level constants, so importing
this module touches no device and no group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh"]


def make_mesh(
    shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"
) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the ranks of the process group."""
    if not dist.is_initialized():
        raise RuntimeError("initialize the process group before building a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the process group, as a (data, model) mesh for tests
    and examples."""
    if not dist.is_initialized():
        raise RuntimeError("initialize the process group before building a mesh")
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device_type)
