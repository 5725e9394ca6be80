"""Per-frame dispatch (x264_tpu/encoder/frame_encode.py): I, IDR, P and B
frames, and the per-MB QP maps (constant, or with AQ / MB-tree offsets)."""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..ops.tables import CHROMA_QP_TABLE, chroma_qp
from .encoder import TYPE_B, TYPE_I, TYPE_IDR, TYPE_P


def dispatch_frame(enc, planes, ftype, qp, ref_tag=None, tree_off=None,
                   pir=None, ref_bwd=None):
    """Returns (finalize_fn, retry_fn(qp) -> (finalize, recon), recon_dev,
    ref_tag). ref_tag: the DPB tag the frame references (None: a P frame
    takes the newest entry), with which it is dispatched again after an
    overflow re-encode repaired the DPB; a B frame names both anchors,
    ref_tag (list 0) and ref_bwd (list 1), and leaves no recon_dev."""
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
    if ftype == TYPE_B:
        from . import bframe
        return bframe.dispatch_bframe(enc, planes, qp, ref_tag, ref_bwd)
    raise ValueError(f"frame type {ftype} has no dispatch")


def build_qp_maps(enc, y, u, v, qp_try, tree_off=None):
    """Per-MB (qp, qp_chroma) int32 maps on the frame's device: AQ offsets
    (+ the lookahead's MB-tree offsets when it provides them), the
    reference's x264_adaptive_quant_frame + macroblock_tree_finish
    composition."""
    mbh, mbw = enc.mb_h, enc.mb_w
    dev = y.device
    if enc.p.rc.aq_mode or tree_off is not None:
        from ..ops.aq import aq_offsets
        adj = (aq_offsets(y, u, v, enc.p.rc.aq_strength)
               if enc.p.rc.aq_mode else
               torch.zeros((mbh, mbw), dtype=torch.float32, device=dev))
        if tree_off is not None:
            adj = adj + torch.as_tensor(np.asarray(tree_off, np.float32),
                                        device=dev)
        qp_mb = torch.round(qp_try + adj).to(torch.int32).clamp(
            enc.p.rc.qp_min, enc.p.rc.qp_max).clamp(0, 51)
        qpc_mb = const(CHROMA_QP_TABLE, dev)[
            (qp_mb + enc.p.analyse.chroma_qp_offset).clamp(0, 51).long()]
        return qp_mb, qpc_mb
    qp_mb = torch.full((mbh, mbw), qp_try, dtype=torch.int32, device=dev)
    qpc = np.asarray(chroma_qp(np.full((mbh, mbw), qp_try),
                               enc.p.analyse.chroma_qp_offset), np.int32)
    return qp_mb, torch.from_numpy(qpc).to(dev)
