"""Elastic scaling: restore any checkpoint onto any surviving device set
(``repro/ft/elastic.py``).

Checkpoints are mesh-agnostic (whole host arrays per leaf), so an elastic
restart is: pick the best mesh for the survivors (:func:`best_mesh_shape`,
:func:`make_elastic_mesh`), carry the plan onto it (:func:`replan`), and
place each leaf in its new spec's placements (:func:`reshard_state`).  A
placed leaf is a DTensor of which each rank holds its piece
(``parallel.specs.place``).

:func:`restore_resharded` goes one step further for large lossy leaves:
their chunked v2/v4 containers are random-access along the leading axis
(``core.chunking.parse_chunked_index`` / ``decompress_chunk``), so a rank
that owns rows ``[r0, r1)`` of a leaf under the new mesh decodes only the
chunks overlapping that range, on its own device, instead of the whole
leaf.  On a changed mesh that turns restore work per rank from O(leaf)
into O(shard) for the optimizer moments, the leaves that dominate a
checkpoint's bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree as tree_util
from ..core import integrity
from ..core import pipeline as pl_mod
from ..core.chunking import ChunkedIndex, decompress_chunk, parse_chunked_index
from ..core.integrity import ContainerError, IntegrityError
from ..models.common import ModelConfig
from ..parallel import specs as sp
from ..parallel.plan import ParallelPlan
from .checkpoint import _template_dtype, decode_leaf, torch_dtype


def best_mesh_shape(n_devices: int, prefer_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) grid using <= n_devices, model as close to
    ``prefer_model`` as divisibility allows (TP axis prefers powers of two)."""
    best = (1, 1)
    m = prefer_model
    while m >= 1:
        d = n_devices // m
        if d >= 1 and d * m > best[0] * best[1]:
            best = (d, m)
        m //= 2
    return best


def make_elastic_mesh(n_devices: Optional[int] = None, prefer_model: int = 16, device=None):
    """A ``DeviceMesh`` named ``("data", "model")`` of :func:`best_mesh_shape`
    over the first d * m ranks of this run (of its first ``n_devices``, by
    default all), NCCL on the card and gloo on the CPU, as
    ``launch/mesh.py`` builds them.  Every rank must call it (the mesh's
    groups are made collectively); a rank beyond d * m sits out, as the
    reference drops devices, and gets ``None``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import _init_process_group

    dev = pl_mod.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    _init_process_group("nccl" if dev.type == "cuda" else "gloo", int(os.environ.get("WORLD_SIZE", 1)))
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"an elastic mesh over {n} devices, this run has {world} processes")
    d, m = best_mesh_shape(n, prefer_model)
    mesh = DeviceMesh(dev.type, torch.arange(d * m).reshape(d, m), mesh_dim_names=("data", "model"))
    return mesh if dist.get_rank() < d * m else None


def replan(cfg: ModelConfig, old_plan: ParallelPlan, mesh) -> ParallelPlan:
    """Carry the old policy onto a new mesh (drop axes the mesh lost)."""
    axes = set(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in old_plan.batch_axes if a in axes) or ("data",)
    fsdp_axes = tuple(a for a in old_plan.fsdp_axes if a in axes)
    seq_axes = tuple(a for a in old_plan.seq_axes if a in axes)
    return dataclasses.replace(old_plan, mesh=mesh, batch_axes=batch_axes, fsdp_axes=fsdp_axes, seq_axes=seq_axes)


def _spec_of(spec_tree, path: str) -> Tuple:
    """The spec at ``path``; a missing or non-spec entry is replicated."""
    try:
        spec = sp.spec_at(spec_tree, path)
    except (KeyError, IndexError, TypeError, AttributeError):
        return ()
    return spec if isinstance(spec, tuple) else ()


def reshard_state(host_state, spec_tree, plan: ParallelPlan):
    """Every leaf of ``host_state`` (whole on every rank: tensors or numpy
    arrays) as a DTensor in its spec's placements on the plan's mesh."""
    from .checkpoint import as_tensor

    flat, treedef = tree_util.flatten_with_path(host_state)
    return tree_util.unflatten(treedef, [sp.place(as_tensor(leaf), _spec_of(spec_tree, p), plan) for p, leaf in flat])


# ---------------------------------------------------------------------------
# chunk-range restore: decode only the chunks a shard needs
# ---------------------------------------------------------------------------

#: codecs whose blobs are v2/v4 multi-chunk containers (random-access rows)
_CHUNKED_CODECS = ("sz3_auto_rel", "sz3_chunked_rel", "sz3_psnr")


@dataclasses.dataclass
class LeafFetch:
    """Byte accounting for one leaf's resharded restore."""

    mode: str  # "chunk-range" | "full"
    bytes_read: int  # container bytes actually decoded
    bytes_full: int  # what a full-leaf decode would have read


@dataclasses.dataclass
class ReshardReport:
    step: int
    leaves: Dict[str, LeafFetch] = dataclasses.field(default_factory=dict)

    @property
    def bytes_read(self) -> int:
        return sum(f.bytes_read for f in self.leaves.values())

    @property
    def bytes_full(self) -> int:
        return sum(f.bytes_full for f in self.leaves.values())

    def summary(self) -> str:
        n_rng = sum(1 for f in self.leaves.values() if f.mode == "chunk-range")
        return (
            f"reshard restore step {self.step}: {n_rng}/{len(self.leaves)} "
            f"leaves by chunk range, {self.bytes_read}/{self.bytes_full} "
            "container bytes decoded"
        )


class ChunkRangeReader:
    """Row-range reads over one chunked container, decoded chunks memoized,
    on ``device`` (default ``"cuda"``).

    Chunk ``i`` covers rows ``[row_starts[i], row_starts[i+1])`` of the
    leaf's leading axis (the checkpoint writer chunks ``leaf.reshape(
    shape[0], -1)`` along axis 0).  A second request for rows already
    decoded costs no decode.
    """

    def __init__(self, blob: bytes, index: Optional[ChunkedIndex] = None, device: pl_mod.Device = None):
        self.blob = blob
        self.index = index or parse_chunked_index(blob)
        self.device = pl_mod.resolve_device(device)
        self._decoded: Dict[int, torch.Tensor] = {}
        self.bytes_read = self.index.body_off  # header always parsed
        starts = [0]
        for c in self.index.header["chunks"]:
            starts.append(starts[-1] + int(c["n0"]))
        self.row_starts = starts

    @property
    def n_rows(self) -> int:
        return self.row_starts[-1]

    def _chunk(self, i: int) -> torch.Tensor:
        if i not in self._decoded:
            self._decoded[i] = decompress_chunk(self.blob, i, parsed=self.index, device=self.device)
            self.bytes_read += self.index.bounds[i][1]
        return self._decoded[i]

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        """Rows ``[r0, r1)`` of the stored flat2d array (a (0, 1) tensor of
        the container's dtype for an empty range)."""
        if not 0 <= r0 <= r1 <= self.n_rows:
            raise IndexError(f"rows [{r0}, {r1}) outside [0, {self.n_rows})")
        parts = []
        for i in range(len(self.index.bounds)):
            c0, c1 = self.row_starts[i], self.row_starts[i + 1]
            if c1 <= r0 or c0 >= r1:
                continue
            part = self._chunk(i)
            part2d = part.reshape(part.shape[0] if part.ndim else part.numel(), -1)
            parts.append(part2d[max(r0 - c0, 0) : r1 - c0])
        if not parts:
            dtype = pl_mod._torch_dtype(self.index.header["dtype"], "dtype")
            return torch.empty((0, 1), dtype=dtype, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _axis0_only(spec, ndim: int) -> bool:
    """True when the spec shards (at most) the leading dim."""
    return all(not axes for axes in sp.spec_entries(spec, ndim)[1:])


def _as_placed(local: torch.Tensor, shape, spec, plan: ParallelPlan):
    """This rank's piece of a leaf of ``shape`` as a DTensor in ``spec``'s
    placements (the piece itself without a mesh)."""
    if plan.mesh is None:
        return local
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, plan.mesh, plan.placements(spec), run_check=False, shape=torch.Size(shape),
                              stride=stride)


def restore_leaf_resharded(
    blob: bytes,
    meta: Dict[str, Any],
    plan: ParallelPlan,
    spec=(),
    device: pl_mod.Device = None,
    like: Optional[torch.dtype] = None,
) -> Tuple[Any, LeafFetch]:
    """One checkpoint leaf as a DTensor in ``spec``'s placements on the
    plan's mesh, on ``device`` (default ``"cuda"``; ``like`` is the
    template's dtype, as in ``checkpoint.decode_leaf``).  A chunked lossy
    leaf whose spec shards at most its leading dim decodes only the chunks
    of this rank's rows; any other leaf is decoded whole and cut."""
    shape = tuple(meta["shape"])
    dev = pl_mod.resolve_device(device)
    if meta.get("codec") in _CHUNKED_CODECS and len(shape) >= 1 and _axis0_only(spec, len(shape)):
        try:
            reader = ChunkRangeReader(blob, device=dev)
        except (ContainerError, ValueError):  # not a chunked container after all: decode it whole
            reader = None
        if reader is not None and reader.n_rows == shape[0]:
            axes = sp.spec_entries(spec, len(shape))[0]
            n = 1
            for a in (plan.present(axes) if plan.mesh is not None else ()):
                n *= plan.axis_size(a)
            if shape[0] % n:
                raise ValueError(f"a dim of {shape[0]} does not split over {n} ranks")
            k = shape[0] // n
            r0 = (plan.axis_rank(axes) if plan.mesh is not None else 0) * k
            local = reader.rows(r0, r0 + k).reshape((k,) + shape[1:]).to(torch_dtype(meta["dtype"], like))
            return _as_placed(local, shape, spec, plan), LeafFetch("chunk-range", reader.bytes_read, len(blob))
    # fallback: decode the full leaf, keep this rank's piece
    whole = decode_leaf(blob, meta, device=dev, like=like)
    if plan.mesh is None:
        return whole, LeafFetch("full", len(blob), len(blob))
    return sp.place(whole, spec, plan), LeafFetch("full", len(blob), len(blob))


def restore_resharded(
    mgr,
    template,
    spec_tree,
    plan: ParallelPlan,
    step: Optional[int] = None,
) -> Tuple[Any, Dict[str, Any], ReshardReport]:
    """Restore checkpoint ``step`` from ``mgr`` directly onto the plan's mesh.

    ``template`` fixes the tree's structure and each leaf's dtype (meta
    tensors are fine, or the state itself); ``spec_tree`` gives each
    leaf's spec on the NEW mesh (missing or non-spec entries mean
    replicated).  Leaves decode on the manager's ``device``.  Large lossy
    leaves restore by chunk range: each rank decodes only the rows it
    owns; everything else is decoded whole and cut.  Each leaf file is
    held to its manifest checksum, as ``CheckpointManager.restore`` holds
    it.  Returns ``(state, extra, ReshardReport)``, the report this rank's.
    """
    steps = mgr.list_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {mgr.dir}")
    step = steps[-1] if step is None else step
    d = Path(mgr.dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = manifest["leaves"]
    flat, treedef = tree_util.flatten_with_path(template)
    report = ReshardReport(step=int(step))
    out = []
    for pstr, leaf in flat:
        if pstr not in leaves:
            raise KeyError(f"leaf {pstr} missing from checkpoint {step}")
        meta = leaves[pstr]
        want = tuple(getattr(leaf, "shape", meta["shape"]))
        if tuple(meta["shape"]) != want:
            raise ValueError(f"{pstr}: checkpoint shape {tuple(meta['shape'])} != expected {want}")
        blob = (d / meta["file"]).read_bytes()
        csum = meta.get("csum")
        if csum is not None and integrity.checksum(blob, algo=csum["a"]) != csum["v"]:
            raise IntegrityError(f"leaf {pstr} fails its {csum['a']} checksum — corrupt checkpoint")
        arr, fetch = restore_leaf_resharded(blob, meta, plan, _spec_of(spec_tree, pstr), device=mgr.device,
                                            like=_template_dtype(leaf))
        report.leaves[pstr] = fetch
        out.append(arr)
    state = tree_util.unflatten(treedef, out)
    return state, manifest.get("extra", {}), report


def validate_divisibility(cfg: ModelConfig, plan: ParallelPlan) -> Dict[str, bool]:
    """Pre-flight checks before committing to a new mesh size."""
    tp = plan.tp
    checks = {
        "d_ff % tp": cfg.d_ff % tp == 0 if cfg.d_ff else True,
        "padded_vocab % tp": cfg.padded_vocab % tp == 0,
        "d_model % fsdp": True,
    }
    for a in plan.fsdp_axes:
        checks["d_model % fsdp"] &= cfg.d_model % plan.axis_size(a) == 0
    return checks
