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
