"""Device meshes on ``torch.distributed`` (``repro/launch/mesh.py``).

:func:`make_debug_mesh` builds a ``DeviceMesh`` over the processes of one
run: NCCL on the card, gloo on the CPU.  The process group comes from the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); without it, a mesh of one device opens a one-rank group
on an in-process store.  Nothing here runs at import.

The reference's ``make_production_mesh`` (16x16 chips a pod, a ``model``
axis of 16) needs tensor parallelism, which is slice 11d of the port
(``ROADMAP.md``).
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
        raise ValueError(f"a mesh of shape {shape} needs {n} processes, this run has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh (a 'model' axis of 16 for tensor parallelism) is slice 11d of the port (ROADMAP.md)"
    )
