"""Quantization / dequantization (x264_tpu/ops/quant.py).

Deadzone forward quant, spec 8.5.10-8.5.12 dequant, flat CQM, int32.
`qp` is a scalar or a tensor broadcastable against the batch dims.
Tables come from ops/tables.py (the port's copy of x264_tpu's).
"""

from __future__ import annotations

import torch

from ..device import const
from . import tables


def _bc_qp(qp, batch_shape, device):
    """qp broadcast to [batch..., 1, 1] int32."""
    q = torch.as_tensor(qp, dtype=torch.int32, device=device)
    return q.expand(batch_shape)[..., None, None]


def quant4x4(w, qp, intra: bool = True, deadzone=None):
    """Deadzone quant of [..., 4, 4] coeffs -> levels (deadzone in 1/64:
    21 intra, 11 inter)."""
    if deadzone is None:
        deadzone = 21 if intra else 11
    q = _bc_qp(qp, w.shape[:-2], w.device)
    mf = const(tables.QUANT4_MF, w.device)[(q[..., 0, 0] % 6).long()]
    qbits = 15 + q // 6
    f = (deadzone << qbits) >> 6
    aw = w.to(torch.int32).abs()
    return torch.sign(w).to(torch.int32) * ((aw * mf + f) >> qbits)


def dequant4x4(levels, qp):
    """Spec 8.5.12.1 dequant of 4x4 AC."""
    q = _bc_qp(qp, levels.shape[:-2], levels.device)
    mf16 = const(tables.DEQUANT4_MF, levels.device)[
        (q[..., 0, 0] % 6).long()] << 4
    shift = q // 6 - 4
    l32 = levels.to(torch.int32) * mf16
    pos = l32 << shift.clamp(min=0)
    rnd = torch.where(shift < 0, 1 << (-shift - 1).clamp(min=0), 0)
    neg = (l32 + rnd) >> (-shift).clamp(min=0)
    return torch.where(shift >= 0, pos, neg)


def quant4x4_dc(h, qp, deadzone: int = 21):
    """Quant of the 4x4 Hadamard of the luma DCs (qbits + 1)."""
    q = _bc_qp(qp, h.shape[:-2], h.device)
    mf00 = const(tables.QUANT4_SCALE, h.device)[(q % 6).long(), 0]
    qbits = 16 + q // 6
    f = (deadzone << qbits) >> 6
    ah = h.to(torch.int32).abs()
    return torch.sign(h).to(torch.int32) * ((ah * mf00 + f) >> qbits)


def dequant4x4_dc(f, qp):
    """Spec 8.5.10: scale the inverse-Hadamard output -> luma DC values."""
    q = _bc_qp(qp, f.shape[:-2], f.device)
    mf16 = const(tables.DEQUANT4_SCALE, f.device)[(q % 6).long(), 0] << 4
    per = q // 6
    l32 = f.to(torch.int32) * mf16
    pos = l32 << (per - 6).clamp(min=0)
    rnd = 1 << (5 - per).clamp(min=0)
    neg = (l32 + rnd) >> (6 - per).clamp(min=0)
    return torch.where(per >= 6, pos, neg)


def quant2x2_dc(h, qp, intra: bool = True, deadzone=None):
    """Quant of the 2x2 chroma-DC Hadamard."""
    if deadzone is None:
        deadzone = 21 if intra else 11
    q = _bc_qp(qp, h.shape[:-2], h.device)
    mf00 = const(tables.QUANT4_SCALE, h.device)[(q % 6).long(), 0]
    qbits = 16 + q // 6
    f = (deadzone << qbits) >> 6
    ah = h.to(torch.int32).abs()
    return torch.sign(h).to(torch.int32) * ((ah * mf00 + f) >> qbits)


def dequant2x2_dc(f, qp):
    """Spec 8.5.11: dcC = ((f * LS) << (qp / 6)) >> 5."""
    q = _bc_qp(qp, f.shape[:-2], f.device)
    mf16 = const(tables.DEQUANT4_SCALE, f.device)[(q % 6).long(), 0] << 4
    return ((f.to(torch.int32) * mf16) << (q // 6)) >> 5


def denoise_dct(w, offset):
    """Noise reduction (x264_tpu ops/quant.denoise_dct): shrink each
    |coefficient| by a learned per-position offset before quantization.
    w [..., 4, 4] int32; offset [4, 4] int32. Returns (denoised
    coefficients, the |w| sums per position [4, 4] int64)."""
    aw = w.to(torch.int32).abs()
    sums = aw.sum(dim=tuple(range(w.dim() - 2)), dtype=torch.int64)
    lvl = (aw - offset.to(torch.int32)).clamp(min=0)
    return torch.sign(w).to(torch.int32) * lvl, sums


def nr_update(nr_strength: int, sums, count: int, prev_sum, prev_count):
    """Host-side offset learning (x264_tpu ops/quant.nr_update, a copy):
    accumulate the position sums, halving past 2^18 samples; offset =
    nr * count / (sum * weight / 256 + 1), DC never denoised.
    Returns (offset [4,4] int32, new_sum, new_count)."""
    import numpy as _np
    s = prev_sum + _np.asarray(sums, _np.int64)
    c = prev_count + int(count)
    if c > (1 << 18):
        s >>= 1
        c >>= 1
    d = tables.DEQUANT4_MF[0].astype(_np.int64)          # {10,13,16} classes
    weight2 = (d * d) >> 2
    off = ((_np.int64(nr_strength) * c + s // 2)
           // (s * weight2 // 256 + 1)).astype(_np.int32)
    off[0, 0] = 0
    return off, s, c
