"""The yardstick of the roofline shares: peaks and bytes needed.

Peaks are data-sheet figures at the card's full power limit (700 W for the
H100 SXM); a run prints the card's ``power.limit`` beside a share.  A
kernel's bytes count what its inputs need: each input byte read once and
each output byte written once, however many launches the port makes.
"""
from __future__ import annotations

from typing import Optional

#: memory bandwidth, bytes/s, by card name (NVIDIA data sheets), most specific first
BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))


def bandwidth(device_name: str) -> Optional[float]:
    for key, rate in BANDWIDTH:
        if key in device_name:
            return rate
    return None


def lorenzo_encode_bytes(elements: int) -> int:
    """float32 in; int32 codes and int32 raw differences out."""
    return 12 * elements


def share(nbytes: float, device_seconds: float, device_name: str) -> Optional[float]:
    """Percent of the bandwidth bound: (bytes / peak) / device time."""
    peak = bandwidth(device_name)
    if peak is None or device_seconds <= 0:
        return None
    return 100.0 * nbytes / peak / device_seconds
