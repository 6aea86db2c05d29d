"""Width buckets (counterpart of ``pick_bucket`` in the JAX package's
``data/gen.py``; the synthetic data stream is not ported yet)."""

from __future__ import annotations

from typing import Sequence


def pick_bucket(width: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= width; doubles the largest bucket past its end."""
    for b in buckets:
        if b >= width:
            return int(b)
    b = int(buckets[-1])
    while b < width:
        b *= 2
    return b
