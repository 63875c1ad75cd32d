"""Counter-based noise: a 32-bit integer hash (lowbias32) in int64
arithmetic, for random numbers that are a pure function of integers already
on the device (no generator state, no host read). Products are split in
16-bit halves so no intermediate exceeds 2**49; the same code runs on Python
ints and tensors. Serving's in-dispatch sampling and quantised training's
stochastic rounding draw from it."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit hash → fp32 u in (0, 1), from its top 23 bits: (k + 0.5) /
    2**23 is exact in fp32 for every k < 2**23, so u never rounds to 0 or
    1 (with 24 bits the top value rounds to 1.0 and its noise is +inf)."""
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))
