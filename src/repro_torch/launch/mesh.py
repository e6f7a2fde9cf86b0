"""Production mesh definitions, as ``torch.distributed`` DeviceMeshes, and the
H100's constants.

The port's counterpart of the JAX package's ``launch/mesh.py``.  The mesh
shapes and axis names are the reference's, so that specs compare one for
one: ``(16, 16)`` on ``("data", "model")`` (256 devices) and ``(2, 16, 16)``
on ``("pod", "data", "model")`` (512).

Ranks are laid out row-major, the last axis fastest, and an H100 node holds
``GPUS_PER_NODE`` = 8 GPUs joined by NVLink; nodes are joined by
InfiniBand.  A 16-wide axis therefore spans two 8-GPU nodes: on both
production meshes the `model` axis (16 consecutive ranks) crosses a node
boundary, and `data` and `pod` (strides of 16 and 256 ranks) join GPUs of
different nodes.  ``axis_link`` says which link an axis's collectives take.

A mesh runs over the default process group when its size matches, and
``make_mesh`` raises when no group is open.  The dry run opens its own:
``open_fake_world`` (called by ``launch/dryrun.main`` and
``benchmarks/torch_perf_lab.py``) starts a fake group of 512 ranks
(``init_process_group("fake", ...)``), whose collectives move nothing, and
smaller meshes are laid over its first ranks.  Importing this module
touches no process group.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.timeline import H100_BF16_FLOPS
from repro_torch.core.whatif import H100_IB_GBPS, H100_NVLINK_GBPS

# H100 SXM hardware constants (per GPU)
PEAK_FLOPS_BF16 = H100_BF16_FLOPS              # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                               # bytes/s
NVLINK_BW = H100_NVLINK_GBPS / 8 * 1e9         # bytes/s per GPU inside a node (450 GB/s)
IB_BW = H100_IB_GBPS / 8 * 1e9                 # bytes/s per GPU across nodes (50 GB/s)
HBM_BYTES = 80 * 1024 ** 3                     # 80 GiB per GPU
GPUS_PER_NODE = 8


FAKE_WORLD = 512           # ranks of the fake group: the largest production mesh


def open_fake_world(size: int = FAKE_WORLD) -> None:
    """The dry run's own process group: ``size`` ranks, this process rank 0,
    every collective a no-op.  Opened once and kept, so that every mesh of
    the process shares one world (DTensor caches plans made on an equal
    mesh, with that mesh's groups); a no-op when a fake group is open, an
    error when another group is."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is open; the dry run "
                               f"needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the default group when its size is the mesh's; over the
    first ranks of a larger fake group (``open_fake_world``); else an
    error, as with no group open."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"no process group is open: a mesh of {n} devices needs "
                           f"init_process_group (or open_fake_world for a dry run)")
    world, backend = dist.get_world_size(), dist.get_backend()
    if world == n:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))
    if backend != "fake" or world < n:
        raise RuntimeError(f"a {backend} process group of {world} ranks is open; a mesh of "
                           f"{n} devices needs one of that size")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1-device mesh with the same axis names, for smoke runs (on the card:
    over a one-rank NCCL group the caller opened)."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def mesh_num_devices(mesh) -> int:
    return mesh.size()


def axis_link(shape: Sequence[int], axis_names: Sequence[str], axis: str,
              gpus_per_node: int = GPUS_PER_NODE) -> Tuple[str, float]:
    """``("nvlink", NVLINK_BW)`` when every group of ``axis`` lies inside one
    node of the row-major rank layout, else ``("ib", IB_BW)``: a ring over
    a group that crosses nodes runs at the slower link."""
    names = list(axis_names)
    i = names.index(axis)
    stride = 1
    for s in shape[i + 1:]:
        stride *= s
    n = 1
    for s in shape:
        n *= s
    for base in range(n):
        if (base // stride) % shape[i]:
            continue                                  # not the first rank of its group
        nodes = {(base + j * stride) // gpus_per_node for j in range(shape[i])}
        if len(nodes) > 1:
            return "ib", IB_BW
    return "nvlink", NVLINK_BW
