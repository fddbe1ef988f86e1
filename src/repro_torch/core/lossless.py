"""Lossless-compressor module (paper §3.2 "Lossless Compressor", Appendix A.5).

The module acts as a proxy around state-of-the-art lossless backends; SZ3
integrates ZSTD / GZIP / BLOSC — here the offline-available analogues
(zstandard, zlib, lzma) sit behind the same two-method interface.  Byte-level
coding stays on the host.  The zstd rule is the JAX package's own: zstd when
``zstandard`` imports, else zlib with the container recording
``lossless="gzip"``.  That is a format rule, not a device fallback.
"""
from __future__ import annotations

import abc
import lzma
import warnings
import zlib
from typing import Dict, Type

from .integrity import ContainerError

try:
    import zstandard as _zstd

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover - exercised where zstandard is absent
    _zstd = None
    _HAVE_ZSTD = False

_warned_no_zstd = False


def _warn_no_zstd() -> None:
    global _warned_no_zstd
    if not _warned_no_zstd:
        warnings.warn(
            "zstandard is not installed; the 'zstd' lossless backend falls "
            "back to zlib (containers will record lossless='gzip'). Install "
            "the [test] extra for the full environment.",
            RuntimeWarning,
            stacklevel=3,
        )
        _warned_no_zstd = True


def _bomb(limit: int, name: str) -> ContainerError:
    return ContainerError(
        f"decompression bomb: {name} stream inflates past the "
        f"header-declared {limit} bytes"
    )


def _zlib_bounded(data: bytes, max_out: int) -> bytes:
    """zlib-decompress at most ``max_out`` bytes; never allocates more than
    ``max_out + 1`` regardless of what the stream claims to inflate to."""
    d = zlib.decompressobj()
    out = d.decompress(data, max_out + 1)
    if len(out) > max_out:
        raise _bomb(max_out, "zlib")
    # returned < max_length => zlib consumed all input; out is complete
    return out + d.flush()


def _lzma_bounded(data: bytes, max_out: int) -> bytes:
    d = lzma.LZMADecompressor()
    out = d.decompress(data, max_out + 1)
    while len(out) <= max_out and not d.eof and not d.needs_input:
        more = d.decompress(b"", max_out + 1 - len(out))
        if not more:
            break
        out += more
    if len(out) > max_out:
        raise _bomb(max_out, "lzma")
    return out


class LosslessBackend(abc.ABC):
    """Paper Appendix A.5: compress(bytes)->bytes / decompress(bytes)->bytes."""

    name: str = "abstract"

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...

    def decompress_bounded(self, data: bytes, max_out: int) -> bytes:
        """Decompress with a hard output ceiling: raise
        :class:`~repro_torch.core.integrity.ContainerError` instead of allocating
        more than ``max_out`` bytes when a (corrupt or hostile) stream
        inflates past the size its container header declared.  Backends
        override this with a streaming-bounded path; the fallback decompresses
        eagerly and only then checks — safe for trusted in-memory use, not a
        bomb guard."""
        out = self.decompress(data)
        if len(out) > max_out:
            raise _bomb(max_out, self.name)
        return out


class Passthrough(LosslessBackend):
    """Module bypass (paper §1: "speed-ratio tradeoffs (module bypass)")."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)


class Zstd(LosslessBackend):
    """zstd when available; degrades to zlib (with a one-time warning) so
    environments without ``zstandard`` still import, compress, and round-trip.
    The instance reports ``name='gzip'`` in fallback mode, keeping containers
    self-describing: blobs written by a fallback instance decode anywhere."""

    name = "zstd"

    def __init__(self, level: int = 3):
        self.level = level
        if _HAVE_ZSTD:
            self._c = _zstd.ZstdCompressor(level=level)
            self._d = _zstd.ZstdDecompressor()
        else:
            _warn_no_zstd()
            self.name = "gzip"  # shadow the class attr: spec stays truthful
            self._c = self._d = None

    def compress(self, data: bytes) -> bytes:
        if self._c is None:
            return zlib.compress(data, min(9, max(1, self.level)))
        return self._c.compress(data)

    def decompress(self, data: bytes) -> bytes:
        if self._d is None:
            try:
                return zlib.decompress(data)
            except zlib.error as e:
                raise RuntimeError(
                    "cannot decompress this blob: it was written with zstd "
                    "but zstandard is not installed in this environment"
                ) from e
        return self._d.decompress(data)

    def decompress_bounded(self, data: bytes, max_out: int) -> bytes:
        if self._d is None:
            return _zlib_bounded(data, max_out)
        try:
            return self._d.decompress(data, max_output_size=max_out)
        except _zstd.ZstdError as e:
            if "output" in str(e).lower():
                raise _bomb(max_out, "zstd") from e
            # ZstdError is no ValueError: a damaged frame must still raise
            # the typed error of the decode contract
            raise ContainerError(f"corrupt zstd stream: {e}") from e


class Gzip(LosslessBackend):
    name = "gzip"

    def __init__(self, level: int = 6):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)

    def decompress_bounded(self, data: bytes, max_out: int) -> bytes:
        return _zlib_bounded(data, max_out)


class Lzma(LosslessBackend):
    name = "lzma"

    def __init__(self, preset: int = 1):
        self.preset = preset

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=self.preset)

    def decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)

    def decompress_bounded(self, data: bytes, max_out: int) -> bytes:
        return _lzma_bounded(data, max_out)


_REGISTRY: Dict[str, Type[LosslessBackend]] = {
    "none": Passthrough,
    "zstd": Zstd,
    "gzip": Gzip,
    "lzma": Lzma,
}


def make(name: str, **kw) -> LosslessBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown lossless backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
