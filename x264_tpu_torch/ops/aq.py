"""Adaptive quantization (x264_tpu/ops/aq.py; reference
x264_adaptive_quant_frame, ratecontrol.c:304, aq-mode 1 variance)."""

from __future__ import annotations

import torch


def aq_offsets(y, u, v, strength):
    """Per-MB qp offsets [mbh, mbw] float32 from block energies
    (AQ_VARIANCE).

    energy = var(luma 16x16) + var(chroma 8x8 each);
    qp_offset = strength * (log2(energy) - 14.427).

    log2 is taken in float64 and rounded to float32: that is the correctly
    rounded float32 log2 on the CPU and on the card alike, so the QP map
    that comes of it (a round to the nearest integer) is the same on both.
    The subtraction and the product stay in float32, as in x264_tpu."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    def mb_var(plane, s):
        t = plane.reshape(mbh, s, mbw, s).transpose(1, 2).to(torch.int32)
        su = t.sum((2, 3), dtype=torch.int32)
        sq = (t * t).sum((2, 3), dtype=torch.int32)
        return sq - torch.div(su * su, s * s, rounding_mode="floor")

    energy = mb_var(y, 16) + mb_var(u, 8) + mb_var(v, 8)
    log_e = torch.log2(energy.clamp(min=1).to(torch.float32)
                       .to(torch.float64)).to(torch.float32)
    return (log_e - 14.427) * strength
