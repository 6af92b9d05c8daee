"""Mesh construction: a port of ``repro/launch/mesh.py`` onto
``init_device_mesh``.

A mesh spans the ranks of an initialized ``torch.distributed`` process
group, one device a rank. Nothing here starts a group: the caller gives
``init_process_group`` its store or address, rank and world size. A mesh
asked for without a group, or with a world that does not hold it, raises;
nothing runs unsharded in its place.
"""
from __future__ import annotations

import math

import torch


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _make(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group "
            "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {dist.get_world_size()}")
    dev = _device_type(device)
    if dev == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ``data`` is the FSDP/batch axis, ``model`` the tensor-parallel
    axis; ``pod`` (multi-pod only) is an outer data-parallel axis.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), device=None):
    """A small mesh over the process group's ranks (tests, smoke);
    ``device`` is "cuda" or "cpu" (default: the card if there is one)."""
    return _make(shape, axes, device)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def dp_degree(mesh) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in batch_axes(mesh))
