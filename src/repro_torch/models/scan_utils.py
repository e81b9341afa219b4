"""Chunking helper of ``repro.models.scan_utils``."""

from __future__ import annotations


def pick_chunk(T: int, target: int = 256) -> int:
    """Largest divisor of T that is <= target (>=1)."""
    c = min(target, T)
    while T % c:
        c -= 1
    return c
