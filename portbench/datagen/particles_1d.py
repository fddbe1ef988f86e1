"""1-D particle series, made on the device.

* ``position``: one coordinate of particles in a periodic box, drifting
  smoothly along the particle order: ``box / 2 + amplitude * sin(2 pi waves
  t + phase)`` plus a random walk of ``step``-sized Gaussian steps, wrapped
  into ``[0, box)`` (the character of ``chip_smoke.py``'s
  ``particle_series``, with the box's periodicity).  The walk is summed in
  a fixed order (:func:`_walk`): a 1-D ``torch.cumsum`` on the card adds
  in an order that changes from call to call, so one seed would give
  fields that differ in a few points.
* ``velocity``: a rougher series, white noise filtered by
  ``k ** (-slope / 2)`` and scaled to deviation ``scale``.  Its lowest
  ``shared_modes`` spectral modes, which set its range, are drawn from one
  fixed seed, the same in every run and field; the field's seed draws the
  rest.  Otherwise the range, and with it the bound and the ratio, would
  swing by some 10% from field to field, and a window holds few of them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.harness.fields import field_seed

#: the seed of the modes that every velocity field shares
_SHARED_SEED = 0x5EED_0F_1A12E
#: the length of the rows a walk is summed along
_ROW = 4096


def _fft_length(n: int) -> int:
    """The least 2^a * 3^b at or above ``n``: an FFT size cuFFT runs fast."""
    best = 1 << max(0, (n - 1).bit_length())
    p3 = 1
    while p3 < n:
        m = p3 << max(0, (-(-n // p3) - 1).bit_length())
        best = min(best, m)
        p3 *= 3
    return best


def _walk(steps: torch.Tensor) -> torch.Tensor:
    """The running sum of ``steps`` (1-D), the same bits on every call: each
    row of ``_ROW`` steps is summed along the row on the device (the scan of
    the innermost axis, whose order is fixed), and the rows' carries on the
    host."""
    n = steps.numel()
    rows = -(-n // _ROW)
    padded = torch.zeros(rows * _ROW, dtype=steps.dtype, device=steps.device)
    padded[:n] = steps
    within = torch.cumsum(padded.view(rows, _ROW), 1)
    carry = torch.zeros(rows, dtype=steps.dtype)
    carry[1:] = torch.cumsum(within[:-1, -1].cpu(), 0)
    return (within + carry.to(steps.device)[:, None]).view(-1)[:n]


def _position(n: int, kind: Dict, gen: torch.Generator, device) -> torch.Tensor:
    phase = float(torch.rand((), generator=gen, device=device, dtype=torch.float64)) * 2 * math.pi
    t = torch.arange(n, device=device, dtype=torch.float64) / n
    walk = _walk(kind["step"] * torch.randn(n, generator=gen, device=device, dtype=torch.float64))
    x = kind["box"] / 2 + kind["amplitude"] * torch.sin(2 * math.pi * kind["waves"] * t + phase) + walk
    return torch.remainder(x, kind["box"]).to(torch.float32)


def _velocity(n: int, kind: Dict, gen: torch.Generator, device) -> torch.Tensor:
    m = _fft_length(n)
    k = torch.fft.rfftfreq(m, d=1.0 / m, device=device, dtype=torch.float64)
    filt = torch.clamp(k, min=1.0) ** (-0.5 * kind["slope"])
    filt[0] = 0.0
    noise = torch.fft.rfft(torch.randn(m, generator=gen, device=device, dtype=torch.float64))
    shared = int(kind.get("shared_modes", 0))
    if shared:
        # white noise's rfft coefficients: complex Gaussian, E|X_k|^2 = m
        fixed = torch.Generator(device=device).manual_seed(_SHARED_SEED)
        parts = torch.randn((2, shared), generator=fixed, device=device, dtype=torch.float64)
        noise[:shared] = torch.complex(parts[0], parts[1]) * math.sqrt(m / 2)
    v = torch.fft.irfft(noise * filt, n=m)[:n]
    v = (v - v.mean()) / v.std()
    return (kind["scale"] * v).to(torch.float32)


_KINDS = {"position": _position, "velocity": _velocity}


def make(config: Dict, items: Sequence[Tuple[int, int]], seed: int, device) -> List[torch.Tensor]:
    """One float32 series of ``config["shape"]`` per (field id, kind index)."""
    (n,) = config["shape"]
    kinds = config["kinds"]
    gen = torch.Generator(device=device)
    out = []
    for fid, k in items:
        gen.manual_seed(field_seed(seed, fid))
        out.append(_KINDS[kinds[k]["post"]](n, kinds[k], gen, device).contiguous())
    return out
