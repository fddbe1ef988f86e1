"""The system under test: one compressor of the port, built once a run.

The only module of the benchmark that imports the port (``repro_torch``).
It takes from it the pipeline a traffic mix names, ``decompress``, the
telemetry spans and the kernel modules' launch counters; nothing else.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib
import pkgutil
from typing import Dict, Iterator, List

import torch


def _span_tree(span) -> List[Dict]:
    """A telemetry span's children as plain dicts, with each span's start
    on the host's ``perf_counter`` clock where the span records one, its
    ``bytes``, and in ``attrs`` every other int, float or str attribute."""
    return [
        {
            "name": c.name,
            "t0": getattr(c, "_t0", None),
            "seconds": c.seconds,
            "bytes": int(c.attrs.get("bytes", 0)),
            "attrs": {k: v for k, v in c.attrs.items() if k != "bytes" and isinstance(v, (int, float, str))},
            "children": _span_tree(c),
        }
        for c in span.children
    ]


@dataclasses.dataclass
class Recording:
    """What a traced call leaves: the span tree and the trace's counters."""

    spans: List[Dict] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


class PortProgram:
    def __init__(self, traffic: Dict, device: str):
        import repro_torch.core as core

        self.core = core
        self.device = device
        self.comp = core.PIPELINES[traffic["pipeline"]](device=device, **traffic.get("options", {}))
        self.conf = core.CompressionConfig(mode=core.ErrorBoundMode(traffic["mode"]), eb=float(traffic["eb"]))

    def _kernel_modules(self) -> Dict[str, object]:
        import repro_torch.kernels as kernels

        mods = {}
        for info in pkgutil.iter_modules(kernels.__path__):
            if info.ispkg:
                mod = importlib.import_module(f"repro_torch.kernels.{info.name}.kernel")
                if hasattr(mod, "LIBRARY"):
                    mods[info.name] = mod
        return mods

    def prepare(self) -> Dict[str, str]:
        """Build (first run in a checkout) or load every kernel library of the
        port, one thread each; returns each library's path."""
        if self.device != "cuda":
            return {}
        mods = self._kernel_modules()
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
            paths = dict(zip(mods, pool.map(lambda m: str(m.LIBRARY.build()), mods.values())))
        for m in mods.values():
            m.LIBRARY.load()
        return paths

    def launches(self) -> Dict[str, int]:
        """Every kernel module's launch counters, as ``<module>.<kernel>``."""
        return {f"{name}.{k}": v for name, m in self._kernel_modules().items() for k, v in m.LAUNCHES.items()}

    def compress(self, x: torch.Tensor):
        res = self.comp.compress(x, self.conf)
        return res.blob, res.ratio

    def decompress(self, blob: bytes) -> torch.Tensor:
        return self.core.decompress(blob, device=self.device)

    @contextlib.contextmanager
    def traced(self) -> Iterator[Recording]:
        """Record the program's spans and counters; the yielded recording
        receives them when the block ends."""
        rec = Recording()
        with self.core.telemetry.trace("portbench") as tr:
            yield rec
        rec.spans.extend(_span_tree(tr.root))
        rec.counters.update(tr.counters)

    def close(self) -> None:
        self.comp = None
