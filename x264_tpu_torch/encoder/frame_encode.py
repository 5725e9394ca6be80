"""Per-frame dispatch (x264_tpu/encoder/frame_encode.py): I, IDR and P
frames (CAVLC)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tables import chroma_qp
from .encoder import TYPE_I, TYPE_IDR, TYPE_P


def dispatch_frame(enc, planes, ftype, qp, ref_tag=None, tree_off=None,
                   pir=None):
    """Returns (finalize_fn, retry_fn(qp) -> (finalize, recon), recon_dev,
    ref_tag)."""
    if enc.p.force_pcm:
        raise NotImplementedError("PCM frames are not ported yet "
                                  "(ROADMAP item 12)")
    if ftype in (TYPE_IDR, TYPE_I):
        from . import intra
        return intra.dispatch_iframe(enc, planes, ftype, qp,
                                     tree_off=tree_off)
    if ftype == TYPE_P:
        from . import inter
        return inter.dispatch_pframe(enc, planes, ftype, qp, ref_tag,
                                     tree_off=tree_off, pir=pir)
    raise NotImplementedError("B frames are not ported yet "
                              "(ROADMAP item 11)")


def build_qp_maps(enc, y, u, v, qp_try, tree_off=None):
    """Per-MB (qp, qp_chroma) int32 maps on the frame's device. Constant
    QP only: the AQ / MB-tree offsets are not ported yet."""
    if enc.p.rc.aq_mode or tree_off is not None:
        raise NotImplementedError("AQ / MB-tree QP offsets are not ported "
                                  "yet (ROADMAP item 10)")
    mbh, mbw = enc.mb_h, enc.mb_w
    qp_mb = torch.full((mbh, mbw), qp_try, dtype=torch.int32,
                       device=y.device)
    qpc = np.asarray(chroma_qp(np.full((mbh, mbw), qp_try),
                               enc.p.analyse.chroma_qp_offset), np.int32)
    return qp_mb, torch.from_numpy(qpc).to(y.device)
