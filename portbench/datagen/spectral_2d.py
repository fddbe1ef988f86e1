"""2-D fields with a power-law spectrum, made on the device.

A torch rewrite of the spectral Gaussian random field that the JAX package's
benchmarks use: white noise filtered by ``k ** (-slope / 2)`` in Fourier
space, normalised to mean 0 and deviation 1 (the mean mode is set to 0
rather than weighted by ``1e-9 ** (-slope / 2)``, which float32 cannot carry).
Each kind then maps the unit field ``g`` to a climate variable's values:

* ``smooth``: ``offset + scale * g`` (temperature-like);
* ``nonneg``: ``scale * max(g - threshold, 0)``, zero over much of the
  globe (precipitation-like);
* ``bounded``: ``clip(center + width * g, 0, 1)`` (cloud-fraction-like).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.harness.fields import field_seed

#: fields filtered in one batch of FFT calls
BATCH = 8


def _post(g: torch.Tensor, kind: Dict) -> torch.Tensor:
    post = kind["post"]
    if post == "smooth":
        return kind["offset"] + kind["scale"] * g
    if post == "nonneg":
        return kind["scale"] * torch.clamp(g - kind["threshold"], min=0.0)
    if post == "bounded":
        return torch.clamp(kind["center"] + kind["width"] * g, 0.0, 1.0)
    raise ValueError(f"unknown post-processing {post!r}")


def make(config: Dict, items: Sequence[Tuple[int, int]], seed: int, device) -> List[torch.Tensor]:
    """One float32 field of ``config["shape"]`` per (field id, kind index)."""
    rows, cols = config["shape"]
    kinds = config["kinds"]
    ky = torch.fft.fftfreq(rows, d=1.0 / rows, device=device, dtype=torch.float32)[:, None]
    kx = torch.fft.rfftfreq(cols, d=1.0 / cols, device=device, dtype=torch.float32)[None, :]
    logk = 0.5 * torch.log(torch.clamp(ky * ky + kx * kx, min=1.0))
    gen = torch.Generator(device=device)
    out: List[torch.Tensor] = []
    for start in range(0, len(items), BATCH):
        batch = items[start : start + BATCH]
        noise = torch.empty((len(batch), rows, cols), device=device, dtype=torch.float32)
        for j, (fid, _) in enumerate(batch):
            gen.manual_seed(field_seed(seed, fid))
            noise[j].normal_(generator=gen)
        slopes = torch.tensor([kinds[k]["slope"] for _, k in batch], device=device, dtype=torch.float32)
        filt = torch.exp(-0.5 * slopes[:, None, None] * logk)
        filt[:, 0, 0] = 0.0
        g = torch.fft.irfft2(torch.fft.rfft2(noise) * filt, s=(rows, cols))
        del noise, filt
        mean = g.mean(dim=(1, 2), keepdim=True, dtype=torch.float64)
        std = g.std(dim=(1, 2), keepdim=True).to(torch.float64)
        g = ((g - mean) / torch.clamp(std, min=math.ulp(1.0))).to(torch.float32)
        for j, (_, k) in enumerate(batch):
            out.append(_post(g[j], kinds[k]).to(torch.float32).contiguous())
        del g
    return out
