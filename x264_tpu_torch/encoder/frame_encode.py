"""Per-frame dispatch (x264_tpu/encoder/frame_encode.py): I, IDR, P and B
frames, I_PCM frames (host only), and the per-MB QP maps (constant, or
with AQ / MB-tree offsets)."""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..entropy import nal as nal_mod
from ..entropy.slice_hdr import slice_header_write
from ..ops._cuda import to_device, to_host
from ..ops.tables import CHROMA_QP_TABLE, chroma_qp
from ..utils import trace
from .encoder import TYPE_B, TYPE_I, TYPE_IDR, TYPE_P


@trace.spanned("analysis:dispatch")
def dispatch_frame(enc, planes, ftype, qp, ref_tag=None, tree_off=None,
                   pir=None, ref_bwd=None):
    """Returns (finalize_fn, retry_fn(qp) -> (finalize, recon), recon_dev,
    ref_tag). ref_tag: the DPB tag the frame references (None: a P frame
    takes the newest entry), with which it is dispatched again after an
    overflow re-encode repaired the DPB; a B frame names both anchors,
    ref_tag (list 0) and ref_bwd (list 1), and leaves no recon_dev."""
    if enc.p.force_pcm and ftype != TYPE_B:
        # x264_tpu dispatches B frames outside this check
        if ftype not in (TYPE_IDR, TYPE_I):
            # as x264_tpu: PCM frames are intra only
            raise NotImplementedError("PCM mode is intra-only")
        nals, recon = encode_frame_pcm(enc, planes, ftype, qp)
        recon_dev = [p.clone() for p in planes]
        return (lambda: (nals, recon)), None, recon_dev, None
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
            adj = adj + to_device(np.asarray(tree_off, np.float32), dev,
                                  "tree_offsets")
        qp_mb = torch.round(qp_try + adj).to(torch.int32).clamp(
            enc.p.rc.qp_min, enc.p.rc.qp_max).clamp(0, 51)
        qpc_mb = const(CHROMA_QP_TABLE, dev)[
            (qp_mb + enc.p.analyse.chroma_qp_offset).clamp(0, 51).long()]
        return qp_mb, qpc_mb
    qp_mb = torch.full((mbh, mbw), qp_try, dtype=torch.int32, device=dev)
    qpc = np.asarray(chroma_qp(np.full((mbh, mbw), qp_try),
                               enc.p.analyse.chroma_qp_offset), np.int32)
    return qp_mb, to_device(qpc, dev, "qp_maps")


def encode_frame_pcm(enc, planes, ftype, qp):
    """I_PCM frame: raw samples, mb_type 25 (spec 7.3.5 / 8.3.5; x264_tpu
    frame_encode.encode_frame_pcm), written on the host from the planes
    copied off the device. Returns (nals, recon as numpy == the source)."""
    sh = enc._slice_header(ftype, qp)
    bw = slice_header_write(sh, nal_ref_idc=nal_mod.NAL_PRIORITY_HIGHEST)
    y, u, v = [to_host(p, "pcm").numpy() for p in planes]
    for mby in range(enc.mb_h):
        for mbx in range(enc.mb_w):
            bw.write_ue(25)           # mb_type I_PCM
            bw.byte_align_zero()      # pcm_alignment_zero_bit
            bw.extend_bytes(y[mby * 16:(mby + 1) * 16,
                              mbx * 16:(mbx + 1) * 16].tobytes())
            bw.extend_bytes(u[mby * 8:(mby + 1) * 8,
                              mbx * 8:(mbx + 1) * 8].tobytes())
            bw.extend_bytes(v[mby * 8:(mby + 1) * 8,
                              mbx * 8:(mbx + 1) * 8].tobytes())
    bw.rbsp_trailing()
    nal_type = (nal_mod.NAL_SLICE_IDR if ftype == TYPE_IDR
                else nal_mod.NAL_SLICE)
    nals = [nal_mod.nal_encode(nal_type, nal_mod.NAL_PRIORITY_HIGHEST,
                               bw.getvalue())]
    return nals, [y.copy(), u.copy(), v.copy()]
