"""The system under test: one compressor of the port, built once a run.

The only module of the benchmark that imports the port (``repro_torch``).
It takes from it the pipeline a traffic mix names, ``decompress``, the
telemetry spans and the kernel modules' launch counters; nothing else.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import pkgutil
from typing import Dict, Iterator, List

import torch


def _span_tree(span) -> List[Dict]:
    """A telemetry span's children as plain dicts, with each span's start
    on the host's ``perf_counter`` clock where the span records one."""
    return [
        {
            "name": c.name,
            "t0": getattr(c, "_t0", None),
            "seconds": c.seconds,
            "bytes": int(c.attrs.get("bytes", 0)),
            "children": _span_tree(c),
        }
        for c in span.children
    ]


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
    def traced(self) -> Iterator[List[Dict]]:
        """Record the program's spans; the yielded list receives their tree."""
        tree: List[Dict] = []
        with self.core.telemetry.trace("portbench") as tr:
            yield tree
        tree.extend(_span_tree(tr.root))

    def close(self) -> None:
        self.comp = None
