"""Reference-frame preparation for motion compensation (x264_tpu/ops/mc.py):
border extension and the 6-tap half-pel planes, built once per DPB push.
"""

from __future__ import annotations

import numpy as np
import torch

PAD = 32          # luma border extension
CPAD = 32         # chroma border

# qpel index (my&3)*4 + (mx&3) -> source hpel planes (0=full,1=H,2=V,3=C)
HPEL_REF0 = np.array([0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1])
HPEL_REF1 = np.array([0, 0, 0, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2])


def _clamped(plane, top, bottom, left, right):
    """Edge-replicate pad as a clamped-index gather (2-D, any dtype)."""
    H, W = plane.shape
    rows = (torch.arange(-top, H + bottom, device=plane.device)
            .clamp(0, H - 1))
    cols = (torch.arange(-left, W + right, device=plane.device)
            .clamp(0, W - 1))
    return plane[rows[:, None], cols[None, :]]


def pad_plane(plane, pad: int = PAD):
    """Edge-replicate border extension by `pad` on every side."""
    return _clamped(plane, pad, pad, pad, pad)


def _tap6(a, dim):
    """(1, -5, 20, 20, -5, 1) along `dim`; output length = length - 5."""
    n = a.shape[dim] - 5
    s = [a.narrow(dim, i, n) for i in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def hpel_planes(padded):
    """(full, H, V, C) uint8 planes [4, Hp, Wp] from a padded full-pel
    plane: H between x and x+1, V between y and y+1, C between both."""
    f = padded.to(torch.int32)
    b1 = _tap6(_clamped(f, 0, 0, 2, 3), 1)            # unrounded H taps
    hplane = ((b1 + 16) >> 5).clamp(0, 255)
    vplane = ((_tap6(_clamped(f, 2, 3, 0, 0), 0) + 16) >> 5).clamp(0, 255)
    cplane = ((_tap6(_clamped(b1, 2, 3, 0, 0), 0) + 512) >> 10).clamp(0, 255)
    return torch.stack([f, hplane, vplane, cplane]).to(torch.uint8)
