"""Production mesh construction over the default process group.

Functions, not module-level constants, so importing this module never
touches a process group. Each mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
axis names, built over the ranks of the default group, which must have
exactly as many ranks as the mesh has places.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks, and none is initialised")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh has {n} places but the "
            f"process group has {world} ranks")
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks per pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    multi_pod: bool = False) -> DeviceMesh:
    """Small mesh for tests (a group of n_data*n_model ranks, twice that
    with multi_pod)."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_single_device_mesh(device: Optional[str] = None) -> DeviceMesh:
    """A (1, 1) ``(data, model)`` mesh on one device. Without a default
    group it first makes a one-rank one: NCCL for the card (the default),
    gloo for ``device="cpu"``, its store a file under a new temporary
    directory, so no TCP port is taken."""
    if not dist.is_initialized():
        _init_one_rank_group(torch.device(device or "cuda"))
    return _mesh((1, 1), ("data", "model"))


def _init_one_rank_group(dev: torch.device) -> None:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a one-rank NCCL mesh needs a CUDA card and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "for a gloo mesh on the CPU")
        torch.cuda.set_device(dev.index or 0)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1),
                            rank=0, world_size=1)
