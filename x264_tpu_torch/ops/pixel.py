"""Pixel metrics (x264_tpu/ops/pixel.py): SATD for the intra mode decision,
and the global SSIM the encoder reports per frame."""

from __future__ import annotations

import torch

from .dct import hadamard4x4


def satd(a, b):
    """Sum over 4x4 tiles of |H (a - b) H^T|, halved (x264 semantics);
    blocks [..., h, w] with h, w multiples of 4."""
    d = a.to(torch.int32) - b.to(torch.int32)
    hh, ww = d.shape[-2], d.shape[-1]
    d = d.reshape(d.shape[:-2] + (hh // 4, 4, ww // 4, 4)).transpose(-3, -2)
    s = hadamard4x4(d).abs().sum(dim=(-2, -1), dtype=torch.int32)
    return s.sum(dim=(-2, -1), dtype=torch.int32) >> 1


# x264 SSIM constants (pixel.c ssim_end1: .01/.03 on 64-px windows)
_SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)
_SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 / 64 + 0.5)


def ssim(a, b):
    """Global SSIM of two planes (x264_tpu ops/pixel.ssim): 4x4-block sums
    combined over 2x2 groups, borders cropped; each window's value in
    float32 as in x264_tpu, their mean in float64, so that the card and the
    CPU, which sum in different orders, agree. Returns a 0-d float64
    tensor on the planes' device."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    H, W = a.shape
    bh, bw = H // 4, W // 4
    ta = a[:bh * 4, :bw * 4].reshape(bh, 4, bw, 4)
    tb = b[:bh * 4, :bw * 4].reshape(bh, 4, bw, 4)
    s1 = ta.sum((1, 3), dtype=torch.int32)
    s2 = tb.sum((1, 3), dtype=torch.int32)
    ss = ((ta * ta).sum((1, 3), dtype=torch.int32)
          + (tb * tb).sum((1, 3), dtype=torch.int32))
    s12 = (ta * tb).sum((1, 3), dtype=torch.int32)

    def grp(x):
        return (x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1]
                + x[1:, 1:]).to(torch.float32)

    g1, g2, gss, g12 = grp(s1), grp(s2), grp(ss), grp(s12)
    vars_ = gss * 64 - g1 * g1 - g2 * g2
    covar = g12 * 64 - g1 * g2
    v = ((2 * g1 * g2 + _SSIM_C1) * (2 * covar + _SSIM_C2)
         / ((g1 * g1 + g2 * g2 + _SSIM_C1) * (vars_ + _SSIM_C2)))
    return v.to(torch.float64).mean()
