"""Integer 4x4 transforms and DC Hadamards (x264_tpu/ops/dct.py).

Batched over leading dims ([..., 4, 4] / [..., 2, 2]) on int32 tensors.
The transforms are written as exact integer butterflies: CUDA has no
integer matmul, and a butterfly is the same linear map.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from . import tables


def _along(x, dim, fn):
    """Apply a 4-point 1-D transform `fn` along `dim` of an int32 tensor."""
    return torch.stack(fn(*x.unbind(dim)), dim=dim)


def _fwd1d(a0, a1, a2, a3):
    # rows of the forward core matrix [[1,1,1,1],[2,1,-1,-2],[1,-1,-1,1],
    # [1,-2,2,-1]]
    s03, d03, s12, d12 = a0 + a3, a0 - a3, a1 + a2, a1 - a2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def _had1d(a0, a1, a2, a3):
    # rows of [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]]
    return (a0 + a1 + a2 + a3, a0 + a1 - a2 - a3, a0 - a1 - a2 + a3,
            a0 - a1 + a2 - a3)


def _inv1d(a0, a1, a2, a3):
    # spec 8.5.12.2 inverse core, one stage
    e0, e1 = a0 + a2, a0 - a2
    e2, e3 = (a1 >> 1) - a3, a1 + (a3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def dct4x4(x):
    """Forward 4x4 core transform CF @ X @ CF^T, batched [..., 4, 4]."""
    x = x.to(torch.int32)
    return _along(_along(x, -2, _fwd1d), -1, _fwd1d)


def idct4x4(d):
    """Inverse 4x4 core on dequantized coeffs: the stage along axis -2
    first, then along axis -1 (the order of the JAX twin), then
    (v + 32) >> 6."""
    d = d.to(torch.int32)
    v = _along(_along(d, -2, _inv1d), -1, _inv1d)
    return (v + 32) >> 6


def hadamard4x4(x):
    """Unscaled 4x4 Hadamard H @ X @ H^T."""
    x = x.to(torch.int32)
    return _along(_along(x, -2, _had1d), -1, _had1d)


def ihadamard4x4(x):
    """Inverse 4x4 Hadamard == forward (scaling lives in the DC dequant)."""
    return hadamard4x4(x)


def dct4x4dc(x):
    """Forward luma-DC transform: 4x4 Hadamard >> 1."""
    return hadamard4x4(x) >> 1


def hadamard2x2(x):
    """2x2 chroma-DC Hadamard: [[a+b+c+d, a-b+c-d], [a+b-c-d, a-b-c+d]]."""
    x = x.to(torch.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return torch.stack([
        torch.stack([a + b + c + d, a - b + c - d], dim=-1),
        torch.stack([a + b - c - d, a - b - c + d], dim=-1)], dim=-2)


ihadamard2x2 = hadamard2x2


def zigzag4(blocks):
    """Scan [..., 4, 4] -> [..., 16] in zig-zag order."""
    flat = blocks.reshape(blocks.shape[:-2] + (16,))
    return flat[..., const(tables.ZIGZAG4_FRAME, blocks.device, torch.int64)]


def izigzag4(scans):
    """Inverse of zigzag4: [..., 16] in zig-zag order -> [..., 4, 4]."""
    inv = np.argsort(tables.ZIGZAG4_FRAME)
    flat = scans[..., const(inv, scans.device, torch.int64)]
    return flat.reshape(scans.shape[:-1] + (4, 4))
