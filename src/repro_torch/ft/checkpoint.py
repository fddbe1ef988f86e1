"""SZ3-compressed, atomic, async checkpointing of a train state.

The JAX package's ``repro.ft.checkpoint``, ported.  A checkpoint written by
either package restores in the other: the leaf paths, the per-leaf codec
choice, every leaf file and the manifest are the reference's, except the
manifest's ``treedef`` (JAX's proto; the port writes ``null``, which no
``restore`` reads) and its ``seconds`` fields.

  * bf16/int parameters   -> lossless: byte-shuffle (BLOSC-style, paper
    §3.2 "Lossless Compressor" instances) + zstd.
  * f32 optimizer moments -> error-bounded lossy at a value-range-relative
    bound (default 1e-4): ``sz3_lorenzo`` below 4 MiB, the five-way chunked
    contest at or above it.
  * arbitrary per-path policy overrides (the composability thesis: choosing
    a pipeline per tensor is a config change, paper §3.3).

Leaves are torch tensors on any device (numpy arrays are accepted too); a
compressed AdamW moment is a node whose ``codes``, ``scale``, ``tags`` and
``base`` are leaves under its path, as in the reference
(:func:`repro_torch.tree.flatten_with_path`).
:meth:`CheckpointManager.save` snapshots every leaf before it returns — a
clone on the leaf's own device — because torch optimizers update tensors in
place.  The lossy leaves then compress from that copy, so on the card the
Lorenzo kernels run the predict stage; the leaf gate (float32/float64, at
least 1024 elements, all finite, ``max - min > 0`` in the leaf's dtype) and
the byte shuffle run on the leaf's device too.  Huffman, zstd and checksums
run on the host, as everywhere in the package.

Durability: manifest + one blob per leaf written to a temp dir, fsync'd,
then atomically renamed to ``step_<n>``; a crash mid-save never corrupts the
previous checkpoint.  Saves run on a background thread (``use_async=True``).
Restore places each leaf on its template leaf's device; a meta-device
template (the port's counterpart of ``jax.eval_shape``) or a shape-only one
places leaves on the manager's ``device`` (default ``"cuda"``), where the
lossy leaves decode.

A bfloat16 leaf has no numpy dtype outside JAX's ``ml_dtypes``, whose
``dtype.str`` is ``'<V2'``: the port writes that string, as the reference
does, and restores the leaf with the template leaf's dtype.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..core import (
    ChunkedCompressor,
    CompressionConfig,
    ErrorBoundMode,
    QualityCompressor,
    decompress as sz3_decompress,
    integrity,
    sz3_lorenzo,
    telemetry,
)
from ..core import pipeline as pl_mod
from ..core.integrity import IntegrityError, decode_errors
from ..core.lossless import Zstd, make as make_lossless

# leaves at/above this size go through the chunked engine (bounded working
# memory per chunk + per-chunk pipeline selection) instead of one-shot Lorenzo
_CHUNKED_MIN_BYTES = 1 << 22

# chunk workers for large lossy leaves: saves run on a background thread
# already, so stay modest — half the cores, at least 1
_CHUNK_WORKERS = max(1, (os.cpu_count() or 2) // 2)

#: the codecs of the lossy leaves: each a self-describing SZ3 container
_SZ3_CODECS = ("sz3_lorenzo_rel", "sz3_chunked_rel", "sz3_auto_rel", "sz3_psnr")

#: the five-way per-chunk contest of large lossy leaves: moments are usually
#: Lorenzo-friendly, attention-derived leaves can oscillate along the feature
#: axis (transform), leaves mixing regimes go to the block hybrid, and
#: near-constant slabs (zero-init moments) to the fast tier's constant blocks
_LOSSY_CANDIDATES = ("sz3_lorenzo", "sz3_lr", "sz3_transform", "sz3_hybrid", "sz3_fast")


# ---------------------------------------------------------------------------
# dtypes: torch <-> the numpy ``dtype.str`` the manifest records
# ---------------------------------------------------------------------------

def dtype_str(dtype: torch.dtype) -> str:
    """The manifest's dtype string of a torch dtype: numpy's ``dtype.str``,
    and ``'<V2'`` for bfloat16 (what ``ml_dtypes.bfloat16`` reports)."""
    if dtype == torch.bfloat16:
        return "<V2"
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def torch_dtype(s: str, like: Optional[torch.dtype] = None) -> torch.dtype:
    """The torch dtype of a manifest dtype string.  A void dtype (bfloat16
    written through numpy) takes ``like``, the template leaf's dtype, when
    its itemsize agrees, else bfloat16."""
    dt = np.dtype(s)
    if dt.kind == "V":
        if like is not None and torch.empty(0, dtype=like).element_size() == dt.itemsize:
            return like
        if dt.itemsize == 2:
            return torch.bfloat16
        raise ValueError(f"no torch dtype for the {dt.itemsize}-byte void dtype {s!r}")
    return torch.from_numpy(np.empty(0, dt)).dtype


def as_tensor(leaf) -> torch.Tensor:
    """A host leaf as a tensor: a tensor as is (detached), a numpy array
    (or anything ``np.asarray`` takes) through ``torch.from_numpy``; a
    2-byte void dtype (``ml_dtypes.bfloat16`` through numpy) as bfloat16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    a = np.asarray(leaf)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16 through numpy
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


def _host_bytes(t: torch.Tensor) -> bytes:
    """The leaf's raw little-endian bytes, through a uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


# ---------------------------------------------------------------------------
# per-leaf codecs
# ---------------------------------------------------------------------------

def _byteshuffle(t: torch.Tensor) -> bytes:
    """BLOSC-style byte shuffle of the leaf's bytes (byte ``j`` of every
    element, then byte ``j + 1``, ...), on the leaf's device."""
    itemsize = t.element_size()
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    if itemsize == 1 or raw.numel() == 0:
        return raw.cpu().numpy().tobytes()
    return raw.reshape(-1, itemsize).t().contiguous().cpu().numpy().tobytes()


def _byteunshuffle(raw: bytes, itemsize: int, nbytes: int) -> bytes:
    n = nbytes - (nbytes % itemsize)
    a = np.frombuffer(raw[:n], np.uint8)
    body = a.reshape(itemsize, -1).T.copy().tobytes()
    return body + raw[n:]


@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    mode: str = "lossless"  # "lossless" | "lossy" | "psnr" | "raw"
    rel_eb: float = 1e-4  # for lossy
    target_psnr: float = 60.0  # for psnr: quality-targeted rate control —
    # the leaf is stored at whatever error bound the closed-loop controller
    # finds to hit the PSNR floor, instead of a hand-picked eb


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Path-keyed policies; first substring match wins."""

    rules: Tuple[Tuple[str, LeafPolicy], ...] = (
        ("opt/m", LeafPolicy("lossy", 1e-4)),
        ("opt/v", LeafPolicy("lossy", 1e-4)),
        ("feedback", LeafPolicy("lossy", 1e-4)),
        ("", LeafPolicy("lossless")),
    )

    def for_path(self, path: str) -> LeafPolicy:
        for pat, pol in self.rules:
            if pat in path:
                return pol
        return LeafPolicy("lossless")


_zstd = Zstd(level=3)


def _lossy_ok(t: torch.Tensor) -> bool:
    """The reference's gate, on the leaf's device: a float32/float64 leaf of
    at least 1024 elements, all finite, whose ``max - min`` (in its own
    dtype: float32 may overflow to inf, which still passes) is positive."""
    if t.dtype not in (torch.float32, torch.float64) or t.numel() < 1024:
        return False
    return bool(torch.isfinite(t).all()) and bool((t.max() - t.min()) > 0)


def encode_leaf(
    arr, pol: LeafPolicy, workers: Optional[int] = None
) -> Tuple[bytes, Dict[str, Any]]:
    """One leaf's blob and manifest entry (shape, dtype, mode, codec).  The
    leaf's own device runs the lossy codecs."""
    t = as_tensor(arr)
    meta: Dict[str, Any] = {
        "shape": list(t.shape),
        "dtype": dtype_str(t.dtype),
        "mode": pol.mode,
    }
    if pol.mode in ("lossy", "psnr") and _lossy_ok(t):
        flat2d = t.reshape(t.shape[0], -1) if t.ndim > 1 else t
        nbytes = t.numel() * t.element_size()
        if pol.mode == "psnr":
            # quality-targeted: the controller finds the bound per chunk;
            # big leaves parallelize exactly like the chunked path
            comp = QualityCompressor(
                target_psnr=pol.target_psnr,
                workers=(_CHUNK_WORKERS if workers is None else workers)
                if nbytes >= _CHUNKED_MIN_BYTES
                else 1,
                device=t.device,
            )
            meta["codec"] = "sz3_psnr"
            res = comp.compress(flat2d)
            meta["achieved_psnr"] = float(res.meta["quality"]["achieved_psnr"])
            return res.blob, meta
        conf = CompressionConfig(mode=ErrorBoundMode.REL, eb=pol.rel_eb)
        if nbytes >= _CHUNKED_MIN_BYTES:
            comp = ChunkedCompressor(
                candidates=_LOSSY_CANDIDATES,
                workers=_CHUNK_WORKERS if workers is None else workers,
                device=t.device,
            )
            meta["codec"] = "sz3_auto_rel"
        else:
            comp = sz3_lorenzo(device=t.device)
            meta["codec"] = "sz3_lorenzo_rel"
        return comp.compress(flat2d, conf).blob, meta
    if pol.mode == "raw":
        meta["codec"] = "raw"
        return _host_bytes(t), meta
    # record the ACTUAL backend (the Zstd class degrades to 'gzip' when
    # zstandard is missing) so restore picks the right decompressor anywhere
    meta["codec"] = f"shuffle_{_zstd.name}"
    return _zstd.compress(_byteshuffle(t)), meta


def decode_leaf(
    blob: bytes,
    meta: Dict[str, Any],
    device: pl_mod.Device = None,
    like: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The leaf ``blob`` holds, as a tensor on ``device`` (default
    ``"cuda"``); ``like`` is the template's dtype, which a void (bfloat16)
    manifest dtype takes."""
    dev = pl_mod.resolve_device(device)
    shape = tuple(meta["shape"])
    dtype = torch_dtype(meta["dtype"], like)
    codec = meta["codec"]
    if codec in _SZ3_CODECS:
        # all are self-describing SZ3 containers (v1 / v2 multi-chunk)
        return sz3_decompress(blob, device=dev).reshape(shape).to(dtype)
    itemsize = np.dtype(meta["dtype"]).itemsize
    count = int(np.prod(shape)) if shape else 1
    if codec == "raw":
        raw = blob
    else:
        nbytes = count * itemsize
        lname = codec.split("_", 1)[1] if codec.startswith("shuffle_") else "zstd"
        backend = _zstd if lname == _zstd.name else make_lossless(lname)
        raw = _byteunshuffle(backend.decompress(blob), itemsize, nbytes)
    if len(raw) < count * itemsize:
        raise ValueError(f"leaf holds {len(raw)} bytes, {count * itemsize} expected")
    u8 = np.frombuffer(raw, np.uint8, count=count * itemsize).copy()
    return torch.from_numpy(u8).view(dtype).reshape(shape).to(dev)


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

def _snapshot(leaf):
    """A copy the caller's in-place updates cannot reach: a clone on the
    tensor's own device, or a numpy copy.  A DTensor is gathered whole
    (``full_tensor()``, a collective every rank of its mesh joins), so a
    sharded state writes the bytes of the same state unsharded."""
    if hasattr(leaf, "full_tensor"):
        return leaf.full_tensor().detach()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


def _clones_done(snap) -> List["torch.cuda.Event"]:
    """One event per CUDA device of ``snap``, recorded on that device's
    current stream after the snapshot's clones were queued there."""
    devices = {t.device for _, t in tree_util.flatten_with_path(snap)[0]
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    events = []
    for dev in sorted(devices, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


def _placement(leaf, default: torch.device) -> torch.device:
    """Where a restored leaf goes: its template tensor's device, or the
    manager's for a meta-device or shape-only template leaf."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return default


def _template_dtype(leaf) -> Optional[torch.dtype]:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt
    if dt is not None and np.dtype(dt).kind == "V" and np.dtype(dt).itemsize == 2:
        return torch.bfloat16
    return None


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        policy: CheckpointPolicy = CheckpointPolicy(),
        keep: int = 3,
        use_async: bool = True,
        workers: Optional[int] = None,
        device: pl_mod.Device = "cuda",
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.policy = policy
        self.keep = keep
        self.workers = workers  # chunk workers for large lossy leaves
        self.device = device  # where shape-only template leaves restore
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if use_async else None
        self._pending: Optional[cf.Future] = None
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        """Snapshot every leaf, then (optionally async) compress + atomic
        write.  Once this returns, in-place updates of ``state`` do not
        reach the checkpoint."""
        flat, treedef = tree_util.flatten_with_path(state)
        snap = tree_util.unflatten(treedef, [_snapshot(leaf) for _, leaf in flat])
        if self._pool is None:
            self._write(step, snap, extra)
            return None
        ready = _clones_done(snap)
        self.wait()
        self._pending = self._pool.submit(self._write_when, ready, step, snap, extra)
        return self._pending

    def _write_when(self, ready: List["torch.cuda.Event"], step: int, state, extra):
        # the clones were queued on the caller's streams; the worker thread
        # reads them on its own, so it waits for them first
        for ev in ready:
            ev.synchronize()
        return self._write(step, state, extra)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, state, extra):
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        leaves = {}
        flat, _ = tree_util.flatten_with_path(state)
        total_in = total_out = 0
        for pstr, leaf in flat:
            pol = self.policy.for_path(pstr)
            t = as_tensor(leaf)
            nbytes = t.numel() * t.element_size()
            t_leaf = time.perf_counter()
            with telemetry.span("leaf", path=pstr, bytes=nbytes):
                blob, meta = encode_leaf(t, pol, workers=self.workers)
            d_leaf = time.perf_counter() - t_leaf
            # per-leaf observability: which codec won, what it cost, what it
            # bought — queryable from the manifest long after the run
            meta["seconds"] = round(d_leaf, 6)
            meta["ratio"] = round(nbytes / max(1, len(blob)), 4)
            telemetry.metric_observe("sz3_checkpoint_leaf_seconds", d_leaf)
            telemetry.observe("checkpoint_leaf_seconds", d_leaf)
            fname = hashlib.sha1(pstr.encode()).hexdigest()[:16] + ".bin"
            (tmp / fname).write_bytes(blob)
            meta["file"] = fname
            meta["crc"] = zlib.crc32(blob)  # kept for pre-integrity readers
            # algorithm-tagged per-leaf checksum (CRC32C when available) —
            # the manifest-side twin of the container trailer, covering raw
            # and lossless leaves that carry no SZ3J framing
            meta["csum"] = {
                "a": integrity.CHECKSUM_ALGO,
                "v": integrity.checksum(blob),
            }
            leaves[pstr] = meta
            total_in += nbytes
            total_out += len(blob)
        manifest = {
            "step": step,
            "leaves": leaves,
            "treedef": None,  # JAX's proto in the reference; no restore reads it
            "bytes_in": total_in,
            "bytes_out": total_out,
            "ratio": total_in / max(1, total_out),
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        telemetry.metric_count("sz3_checkpoint_saves_total")
        telemetry.metric_count("sz3_checkpoint_bytes_out_total", total_out)
        # fsync the directory entries before rename (durability)
        for f in tmp.iterdir():
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return manifest

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def list_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                pass
        return sorted(out)

    def restore(
        self,
        template,
        step: Optional[int] = None,
        *,
        salvage: bool = False,
        io_retries: int = 3,
        io_backoff: float = 0.05,
    ):
        """Restore into the structure of ``template``.  Returns
        ``(state, extra)``.

        ``template`` supplies the tree structure, each leaf's shape and
        dtype, and its placement: a tensor's device, or the manager's
        ``device`` for a meta-device tensor or a shape-only leaf (anything
        with ``shape`` and ``dtype``).  Leaves are validated against the
        manifest and their per-leaf checksums.

        ``salvage=True`` turns a corrupt leaf from a restore-killing error
        into a local loss: damaged / missing / shape-mismatched leaves are
        REFILLED from the template's own values (zeros when the template
        leaf is shape-only) and the call returns ``(state, extra,
        RestoreReport)`` naming what was refilled.

        Transient I/O errors (``OSError`` other than a missing file) are
        retried ``io_retries`` times with exponential backoff starting at
        ``io_backoff`` seconds."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        d = self.dir / f"step_{step}"
        manifest = json.loads(
            self._read_retry(d / "manifest.json", io_retries, io_backoff).decode()
        )
        leaves = manifest["leaves"]
        flat, treedef = tree_util.flatten_with_path(template)
        default = pl_mod.resolve_device(self.device)
        out = []
        report = RestoreReport(step=int(step))
        for pstr, leaf in flat:
            dev = _placement(leaf, default)
            try:
                arr = self._restore_leaf(
                    d, leaves, pstr, step, leaf, dev, io_retries, io_backoff
                )
            except FileNotFoundError:
                if not salvage:
                    raise
                arr, reason = None, "missing"
            except (KeyError, LookupError):
                if not salvage:
                    raise
                arr, reason = None, "missing"
            except (IntegrityError, IOError):
                if not salvage:
                    raise
                arr, reason = None, "checksum"
            except ValueError:
                if not salvage:
                    raise
                arr, reason = None, "decode-error"
            if arr is None:
                arr = _template_fill(leaf, dev)
                report.refilled.append((pstr, reason))
            else:
                report.restored.append(pstr)
            out.append(arr)
        state = tree_util.unflatten(treedef, out)
        extra = manifest.get("extra", {})
        if salvage:
            return state, extra, report
        return state, extra

    def _restore_leaf(
        self, d: Path, leaves, pstr: str, step, leaf, dev, io_retries, io_backoff
    ) -> torch.Tensor:
        if pstr not in leaves:
            raise KeyError(f"leaf {pstr} missing from checkpoint {step}")
        meta = leaves[pstr]
        blob = self._read_retry(d / meta["file"], io_retries, io_backoff)
        csum = meta.get("csum")
        if csum is not None:
            if integrity.checksum(blob, algo=csum["a"]) != csum["v"]:
                raise IntegrityError(
                    f"leaf {pstr} fails its {csum['a']} checksum — corrupt "
                    "checkpoint"
                )
        elif zlib.crc32(blob) != meta["crc"]:  # pre-integrity manifests
            raise IOError(f"checksum mismatch for {pstr} — corrupt checkpoint")
        with decode_errors(f"checkpoint leaf {pstr}"):
            arr = decode_leaf(blob, meta, device=dev, like=_template_dtype(leaf))
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{pstr}: checkpoint shape {tuple(arr.shape)} != expected {want_shape}"
            )
        return arr

    @staticmethod
    def _read_retry(path: Path, retries: int, backoff: float) -> bytes:
        """Read with bounded retry-with-backoff on transient I/O errors.
        A missing file is NOT transient (the checkpoint layout is immutable
        once renamed into place) and raises immediately."""
        attempt = 0
        while True:
            try:
                return path.read_bytes()
            except FileNotFoundError:
                raise
            except OSError:
                if attempt >= retries:
                    raise
                time.sleep(backoff * (2**attempt))
                attempt += 1


@dataclasses.dataclass
class RestoreReport:
    """What a ``salvage=True`` restore recovered vs refilled."""

    step: int
    restored: List[str] = dataclasses.field(default_factory=list)
    refilled: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.refilled

    def summary(self) -> str:
        if self.ok:
            return f"restore step {self.step}: all {len(self.restored)} leaves"
        lost = ", ".join(f"{p} ({r})" for p, r in self.refilled)
        return (
            f"restore step {self.step}: {len(self.restored)} leaves restored, "
            f"{len(self.refilled)} refilled from template: {lost}"
        )


def _template_fill(leaf, dev: torch.device) -> torch.Tensor:
    """A replacement value for a leaf the checkpoint could not supply: the
    template's own value when it carries one, zeros when it is shape-only
    (a meta-device tensor, or anything with ``shape`` and ``dtype``)."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.detach().clone()
    if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "__array__"):
        return as_tensor(leaf).to(dev)
    dtype = _template_dtype(leaf) or torch.from_numpy(np.empty(0, np.dtype(getattr(leaf, "dtype", "f4")))).dtype
    return torch.zeros(tuple(getattr(leaf, "shape", ())), dtype=dtype, device=dev)
