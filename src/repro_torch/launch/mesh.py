"""Device meshes on ``torch.distributed`` (``repro/launch/mesh.py``).

:func:`make_debug_mesh` builds a ``DeviceMesh`` over the processes of one
run: NCCL on the card, gloo on the CPU.  The process group comes from the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); without it, a mesh of one device opens a one-rank group
on an in-process store.  Nothing here runs at import.

:func:`make_production_mesh` is the reference's: 16 x 16 devices a pod
(``data`` x ``model``), two pods (``pod`` x ``data`` x ``model``) when
``multi_pod``, over as many processes.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _init_process_group(backend: str, n_devices: int) -> None:
    if dist.is_initialized():
        return
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend)
    elif n_devices == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs one process per device: run under torchrun "
            f"(--nproc-per-node {n_devices}), which sets {', '.join(_TORCHRUN_ENV)}"
        )


def make_debug_mesh(shape: Sequence[int] = (1, 1), axes: Sequence[str] = ("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over this run's processes,
    one device each, on ``device`` (``"cuda"`` by default, or ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.pipeline import resolve_device

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    dev = resolve_device(device)
    n = math.prod(shape)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    _init_process_group("nccl" if dev.type == "cuda" else "gloo", n)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} processes, this run has {dist.get_world_size()}: "
                         f"run under torchrun --nproc-per-node {n}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices a pod; 2 pods = 512 when ``multi_pod``: a
    ``DeviceMesh`` over this run's processes (``torchrun`` with that many),
    on ``device`` (``"cuda"`` by default)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} processes, this run has "
                         f"{dist.get_world_size()}: run under torchrun with --nnodes/--nproc-per-node to match")
    return make_debug_mesh(shape, axes, device=device)
