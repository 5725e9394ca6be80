"""Slice header construction/serialization (spec 7.3.3; reference
encoder/encoder.c:~190 `slice_header_init` / `slice_header_write`).

The port's own copy of `x264_tpu/entropy/slice_hdr.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitWriter
from .sets import SPS, PPS

SLICE_TYPE_P, SLICE_TYPE_B, SLICE_TYPE_I = 0, 1, 2


@dataclass
class SliceHeader:
    sps: SPS = None
    pps: PPS = None
    slice_type: int = SLICE_TYPE_I
    first_mb: int = 0
    last_mb: int = 0
    frame_num: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    poc_lsb: int = 0
    qp: int = 26
    # ref handling
    direct_spatial_mv_pred: bool = True
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    num_ref_idx_override: bool = False
    ref_pic_list_mod_l0: list = field(default_factory=list)  # (op, arg)
    mmco: list = field(default_factory=list)                 # (op, args...)
    cabac_init_idc: int = 0
    # weighted prediction (pred_weight_table, spec 7.3.3.2): per-l0-ref
    # (w, o) luma pairs or None for unity; denom fixed at 7 (x264's
    # starting denom, slicetype.c:284). Chroma stays unweighted.
    weight_denom_luma: int = 7
    weight_l0: list = field(default_factory=list)   # [(w, o) | None]
    # deblocking
    disable_deblocking_filter_idc: int = 0
    alpha_c0_offset: int = 0      # in units of 2 (stored as offset_div2*2)
    beta_offset: int = 0


def slice_header_write(sh: SliceHeader, nal_ref_idc: int) -> BitWriter:
    """Serialize up to (not including) slice data. Returns the open writer so
    the MB-layer entropy can continue in the same bitstream."""
    bw = BitWriter()
    bw.write_ue(sh.first_mb)
    bw.write_ue(sh.slice_type + 5)   # +5: "all slices same type in pic"
    bw.write_ue(sh.pps.id)
    bw.write(sh.sps.log2_max_frame_num, sh.frame_num)
    if not sh.sps.frame_mbs_only:
        raise NotImplementedError("interlaced")
    if sh.idr:
        bw.write_ue(sh.idr_pic_id)
    if sh.sps.poc_type == 0:
        bw.write(sh.sps.log2_max_poc_lsb, sh.poc_lsb)
    if sh.slice_type == SLICE_TYPE_B:
        bw.write1(int(sh.direct_spatial_mv_pred))
    if sh.slice_type in (SLICE_TYPE_P, SLICE_TYPE_B):
        bw.write1(int(sh.num_ref_idx_override))
        if sh.num_ref_idx_override:
            bw.write_ue(sh.num_ref_idx_l0_active - 1)
            if sh.slice_type == SLICE_TYPE_B:
                bw.write_ue(sh.num_ref_idx_l1_active - 1)
    # ref_pic_list_modification
    if sh.slice_type in (SLICE_TYPE_P, SLICE_TYPE_B):
        if sh.ref_pic_list_mod_l0:
            bw.write1(1)
            for op, arg in sh.ref_pic_list_mod_l0:
                bw.write_ue(op)
                bw.write_ue(arg)
            bw.write_ue(3)
        else:
            bw.write1(0)
        if sh.slice_type == SLICE_TYPE_B:
            bw.write1(0)
    if sh.pps.weighted_pred and sh.slice_type == SLICE_TYPE_P:
        # pred_weight_table (spec 7.3.3.2): luma (w, o) per l0 ref;
        # chroma always unweighted (chroma_weight_l0_flag = 0)
        weights = sh.weight_l0 or [None] * sh.num_ref_idx_l0_active
        any_w = any(w is not None for w in weights)
        bw.write_ue(sh.weight_denom_luma if any_w else 0)
        bw.write_ue(0)                       # chroma_log2_weight_denom
        for entry in weights:
            if entry is None:
                bw.write1(0)                 # luma_weight_l0_flag
            else:
                w, o = entry
                bw.write1(1)
                bw.write_se(w)
                bw.write_se(o)
            bw.write1(0)                     # chroma_weight_l0_flag
    if nal_ref_idc:
        if sh.idr:
            bw.write1(0)   # no_output_of_prior_pics
            bw.write1(0)   # long_term_reference_flag
        else:
            if sh.mmco:
                bw.write1(1)
                for op, *args in sh.mmco:
                    bw.write_ue(op)
                    for a in args:
                        bw.write_ue(a)
                bw.write_ue(0)
            else:
                bw.write1(0)
    if sh.pps.cabac and sh.slice_type != SLICE_TYPE_I:
        bw.write_ue(sh.cabac_init_idc)
    bw.write_se(sh.qp - sh.pps.pic_init_qp)
    if sh.pps.deblocking_filter_control:
        bw.write_ue(sh.disable_deblocking_filter_idc)
        if sh.disable_deblocking_filter_idc != 1:
            bw.write_se(sh.alpha_c0_offset // 2)
            bw.write_se(sh.beta_offset // 2)
    return bw
