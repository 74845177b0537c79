"""Rounding of float32 values to a lower precision, for the control."""

from __future__ import annotations

import numpy as np


def bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even), kept
    as float32."""
    a = np.asarray(x, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32)
    out = np.where(np.isfinite(a), out, a)
    return out if a.shape else np.float32(out)
