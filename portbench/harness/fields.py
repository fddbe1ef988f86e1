"""Which field of a configuration each position of a run's loop gets.

A configuration lists field kinds (``kinds``).  A run's fields come in
groups of one field of each kind, so every window holds the same mix; the
seed orders the kinds within each group and draws each field's noise.  The
loop closes its window only between groups.
"""
from __future__ import annotations

import random
from typing import List, Tuple

_MASK = (1 << 64) - 1
#: field ids at and above this are warm-up fields, never in a window
WARMUP_BASE = 1 << 40


def field_seed(seed: int, field_id: int) -> int:
    """A 63-bit seed for one field, mixed from the run's seed (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(field_id) + 1) & _MASK
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mul) & _MASK
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def plan(n_fields: int, n_kinds: int, seed: int) -> List[Tuple[int, int]]:
    """(field id, kind index) for whole groups covering at most
    ``n_fields``; each group holds every kind once, in the seed's order."""
    if n_kinds < 1 or n_fields < n_kinds:
        raise ValueError(f"{n_fields} fields cannot hold a group of {n_kinds} kinds")
    rng = random.Random(field_seed(seed, -1))
    items = []
    for g in range(n_fields // n_kinds):
        order = list(range(n_kinds))
        rng.shuffle(order)
        items += [(g * n_kinds + j, k) for j, k in enumerate(order)]
    return items


def warmup_plan(n_kinds: int) -> List[Tuple[int, int]]:
    """One warm-up field of each kind, with ids no window uses."""
    return [(WARMUP_BASE + k, k) for k in range(n_kinds)]
