"""SPS / PPS construction and serialization.

Reference: encoder/set.c:101 (`x264_sps_init`), set.c:305 (`x264_sps_write`),
set.c:479/505 (PPS), set.c:876 (`x264_validate_levels`); levels table
x264.h:630-648. Written per H.264 spec sections 7.3.2.1 / 7.3.2.2.

The port's own copy of `x264_tpu/entropy/sets.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitWriter
from .. import params as P


# H.264 levels table: (level_idc, mbps, frame_size_in_mbs, dpb_mbs,
#                      bitrate, cpb, mv_range, mvs_per_2mb, slice_rate,
#                      mincr, bipred8x8, direct8x8, frame_only)
LEVELS = [
    (10,     1485,     99,    396,     64,    175,  64, 64,  0, 2, 0, 0, 1),
    (9,      1485,     99,    396,    128,    350,  64, 64,  0, 2, 0, 0, 1),  # 1b
    (11,     3000,    396,    900,    192,    500, 128, 64,  0, 2, 0, 0, 1),
    (12,     6000,    396,   2376,    384,   1000, 128, 64,  0, 2, 0, 0, 1),
    (13,    11880,    396,   2376,    768,   2000, 128, 64,  0, 2, 0, 0, 1),
    (20,    11880,    396,   2376,   2000,   2000, 128, 64,  0, 2, 0, 0, 1),
    (21,    19800,    792,   4752,   4000,   4000, 256, 64,  0, 2, 0, 0, 0),
    (22,    20250,   1620,   8100,   4000,   4000, 256, 64,  0, 2, 0, 0, 0),
    (30,    40500,   1620,   8100,  10000,  10000, 256, 32, 22, 2, 0, 1, 0),
    (31,   108000,   3600,  18000,  14000,  14000, 512, 16, 60, 4, 1, 1, 0),
    (32,   216000,   5120,  20480,  20000,  20000, 512, 16, 60, 4, 1, 1, 0),
    (40,   245760,   8192,  32768,  20000,  25000, 512, 16, 60, 4, 1, 1, 0),
    (41,   245760,   8192,  32768,  50000,  62500, 512, 16, 24, 2, 1, 1, 0),
    (42,   522240,   8704,  34816,  50000,  62500, 512, 16, 24, 2, 1, 1, 0),
    (50,   589824,  22080, 110400, 135000, 135000, 512, 16, 24, 2, 1, 1, 0),
    (51,   983040,  36864, 184320, 240000, 240000, 512, 16, 24, 2, 1, 1, 0),
    (52,  2073600,  36864, 184320, 240000, 240000, 512, 16, 24, 2, 1, 1, 0),
    (60,  4177920, 139264, 696320, 240000, 240000, 8192, 16, 24, 2, 1, 1, 0),
    (61,  8355840, 139264, 696320, 480000, 480000, 8192, 16, 24, 2, 1, 1, 0),
    (62, 16711680, 139264, 696320, 800000, 800000, 8192, 16, 24, 2, 1, 1, 0),
]


def level_autodetect(p: P.Params, num_ref: int) -> int:
    """Pick the lowest level that fits (simplified x264_validate_levels)."""
    mbs = p.mb_width * p.mb_height
    dpb = mbs * num_ref
    mbps = mbs * p.fps_num / max(1, p.fps_den)
    for (idc, l_mbps, l_fs, l_dpb, *_rest) in LEVELS:
        if idc == 9:
            continue
        if (mbs <= l_fs and dpb <= l_dpb and mbps <= l_mbps
                and p.mb_width <= (8 * l_fs) ** 0.5
                and p.mb_height <= (8 * l_fs) ** 0.5):
            return idc
    return 62


@dataclass
class SPS:
    """Sequence parameter set (subset we emit; spec 7.3.2.1)."""
    id: int = 0
    profile_idc: int = P.PROFILE_HIGH
    level_idc: int = 40
    constraint_set0: bool = False
    constraint_set1: bool = False
    constraint_set2: bool = False
    constraint_set3: bool = False
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass: bool = False
    log2_max_frame_num: int = 9
    poc_type: int = 0
    log2_max_poc_lsb: int = 10
    num_ref_frames: int = 3
    gaps_in_frame_num_allowed: bool = False
    mb_width: int = 0
    mb_height: int = 0
    frame_mbs_only: bool = True
    mb_adaptive_frame_field: bool = False
    direct8x8_inference: bool = True
    crop: tuple = (0, 0, 0, 0)       # left, right, top, bottom (pixels)
    vui_params_present: bool = True
    # VUI subset
    sar: tuple = (0, 0)
    overscan: int = 0
    vidformat: int = 5
    fullrange: bool = False
    color_description_present: bool = False
    colorprim: int = 2
    transfer: int = 2
    colmatrix: int = 2
    chroma_loc: int = 0
    timing_info_present: bool = True
    num_units_in_tick: int = 1
    time_scale: int = 50
    fixed_frame_rate: bool = True
    bitstream_restriction: bool = True
    max_num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 3
    # HRD (spec E.1.2; present when VBV is configured)
    nal_hrd_parameters: bool = False
    hrd_bitrate: int = 0             # bits/s
    hrd_cpb_size: int = 0            # bits
    hrd_bitrate_unscaled: int = 0    # value a decoder reconstructs
    hrd_cpb_size_unscaled: int = 0
    hrd_cbr: bool = False
    initial_cpb_removal_delay_length: int = 24
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24
    pic_struct_present: bool = False


def sps_init(p: P.Params, sps_id: int = 0) -> SPS:
    """Build SPS from validated params (reference: set.c:101)."""
    sps = SPS(id=sps_id)
    lossless = p.rc.rc_method == P.RC_CQP and p.rc.qp_constant <= 0
    csp = p.chroma_format_idc
    if lossless:
        sps.profile_idc = P.PROFILE_HIGH444
    elif csp >= 3:
        sps.profile_idc = P.PROFILE_HIGH444
    elif csp == 2:
        sps.profile_idc = P.PROFILE_HIGH422
    elif p.bitdepth > 8:
        sps.profile_idc = P.PROFILE_HIGH10
    elif p.analyse.transform_8x8 or p.cqm_preset != P.CQM_FLAT:
        sps.profile_idc = P.PROFILE_HIGH
    elif p.bframe > 0 or p.interlaced or p.cabac:
        sps.profile_idc = P.PROFILE_MAIN
    else:
        sps.profile_idc = P.PROFILE_BASELINE
    sps.constraint_set0 = sps.profile_idc == P.PROFILE_BASELINE
    sps.constraint_set1 = sps.profile_idc <= P.PROFILE_MAIN
    sps.chroma_format_idc = csp
    sps.bit_depth_luma = sps.bit_depth_chroma = p.bitdepth
    sps.qpprime_y_zero_transform_bypass = lossless
    sps.mb_width, sps.mb_height = p.mb_width, p.mb_height
    # B frames keep both anchors referenced -> DPB needs >= 2 slots
    sps.num_ref_frames = max(max(1, p.frame_reference),
                             2 if p.bframe > 0 else 1) \
        + (p.bframe_pyramid > 0 and p.bframe > 0)
    sps.poc_type = 0 if (p.bframe or p.interlaced) else 2
    sps.frame_mbs_only = not p.interlaced
    sps.direct8x8_inference = True
    sps.level_idc = (p.level_idc if p.level_idc > 0
                     else level_autodetect(p, sps.num_ref_frames))
    # crop from display size vs mb-aligned size
    crop_r = sps.mb_width * 16 - p.width
    crop_b = sps.mb_height * 16 - p.height
    sps.crop = (0, crop_r, 0, crop_b)
    # VUI
    sps.sar = (p.vui.sar_width, p.vui.sar_height)
    sps.fullrange = p.vui.fullrange == 1
    sps.color_description_present = (
        p.vui.colorprim != 2 or p.vui.transfer != 2
        or (p.vui.colmatrix not in (-1, 2)))
    sps.colorprim = p.vui.colorprim
    sps.transfer = p.vui.transfer
    sps.colmatrix = p.vui.colmatrix if p.vui.colmatrix >= 0 else 2
    sps.timing_info_present = p.fps_num > 0
    sps.num_units_in_tick = p.fps_den
    sps.time_scale = p.fps_num * 2
    sps.fixed_frame_rate = not p.vfr_input
    sps.max_num_reorder_frames = min(p.bframe, 1) + (p.bframe_pyramid > 0)
    sps.max_dec_frame_buffering = sps.num_ref_frames
    # HRD (reference set.c hrd setup; requires VBV, encoder.c:538)
    if (p.nal_hrd != P.NAL_HRD_NONE and p.rc.vbv_buffer_size > 0
            and p.rc.vbv_max_bitrate > 0):
        sps.nal_hrd_parameters = True
        sps.hrd_bitrate = p.rc.vbv_max_bitrate * 1000
        sps.hrd_cpb_size = p.rc.vbv_buffer_size * 1000
        sps.hrd_cbr = p.nal_hrd == P.NAL_HRD_CBR
        # the values the decoder will reconstruct from the scaled fields
        # (reference set.c keeps *_unscaled for hrd_fullness math)
        sps.hrd_bitrate_unscaled = max(1, sps.hrd_bitrate >> 10) << 10
        sps.hrd_cpb_size_unscaled = max(1, sps.hrd_cpb_size >> 7) << 7
    sps.pic_struct_present = p.pic_struct
    return sps


def sps_write(sps: SPS) -> bytes:
    bw = BitWriter()
    bw.write(8, sps.profile_idc)
    bw.write1(int(sps.constraint_set0))
    bw.write1(int(sps.constraint_set1))
    bw.write1(int(sps.constraint_set2))
    bw.write1(int(sps.constraint_set3))
    bw.write(4, 0)  # reserved_zero_4bits
    bw.write(8, sps.level_idc)
    bw.write_ue(sps.id)
    if sps.profile_idc >= P.PROFILE_HIGH:
        bw.write_ue(sps.chroma_format_idc)
        if sps.chroma_format_idc == 3:
            bw.write1(0)  # separate_colour_plane_flag
        bw.write_ue(sps.bit_depth_luma - 8)
        bw.write_ue(sps.bit_depth_chroma - 8)
        bw.write1(int(sps.qpprime_y_zero_transform_bypass))
        bw.write1(0)  # seq_scaling_matrix_present (CQM TODO: scaling lists)
    bw.write_ue(sps.log2_max_frame_num - 4)
    bw.write_ue(sps.poc_type)
    if sps.poc_type == 0:
        bw.write_ue(sps.log2_max_poc_lsb - 4)
    bw.write_ue(sps.num_ref_frames)
    bw.write1(int(sps.gaps_in_frame_num_allowed))
    bw.write_ue(sps.mb_width - 1)
    bw.write_ue(sps.mb_height - 1)
    bw.write1(int(sps.frame_mbs_only))
    if not sps.frame_mbs_only:
        bw.write1(int(sps.mb_adaptive_frame_field))
    bw.write1(int(sps.direct8x8_inference))
    crop = any(sps.crop)
    bw.write1(int(crop))
    if crop:
        # units: SubWidthC/SubHeightC for 4:2:0 => /2
        dx = 2 if sps.chroma_format_idc in (1, 2) else 1
        dy = 2 if sps.chroma_format_idc == 1 else 1
        bw.write_ue(sps.crop[0] // dx)
        bw.write_ue(sps.crop[1] // dx)
        bw.write_ue(sps.crop[2] // dy)
        bw.write_ue(sps.crop[3] // dy)
    bw.write1(int(sps.vui_params_present))
    if sps.vui_params_present:
        _vui_write(bw, sps)
    bw.rbsp_trailing()
    return bw.getvalue()


def _vui_write(bw: BitWriter, sps: SPS) -> None:
    sar_w, sar_h = sps.sar
    if sar_w and sar_h:
        bw.write1(1)
        std_sars = [(1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
                    (20, 11), (32, 11), (80, 33), (18, 11), (15, 11),
                    (64, 33), (160, 99), (4, 3), (3, 2), (2, 1)]
        if (sar_w, sar_h) in std_sars:
            bw.write(8, std_sars.index((sar_w, sar_h)) + 1)
        else:
            bw.write(8, 255)
            bw.write(16, sar_w)
            bw.write(16, sar_h)
    else:
        bw.write1(0)
    bw.write1(int(sps.overscan != 0))
    if sps.overscan:
        bw.write1(int(sps.overscan == 2))
    signal = (sps.vidformat != 5 or sps.fullrange
              or sps.color_description_present)
    bw.write1(int(signal))
    if signal:
        bw.write(3, sps.vidformat)
        bw.write1(int(sps.fullrange))
        bw.write1(int(sps.color_description_present))
        if sps.color_description_present:
            bw.write(8, sps.colorprim)
            bw.write(8, sps.transfer)
            bw.write(8, sps.colmatrix)
    if sps.chroma_loc:
        bw.write1(1)
        bw.write_ue(sps.chroma_loc)
        bw.write_ue(sps.chroma_loc)
    else:
        bw.write1(0)
    bw.write1(int(sps.timing_info_present))
    if sps.timing_info_present:
        bw.write(32, sps.num_units_in_tick)
        bw.write(32, sps.time_scale)
        bw.write1(int(sps.fixed_frame_rate))
    bw.write1(int(sps.nal_hrd_parameters))
    if sps.nal_hrd_parameters:
        # hrd_parameters (spec E.1.2): one CPB, scaled rate/size
        bw.write_ue(0)                       # cpb_cnt_minus1
        br_scale, cpb_scale = 4, 3          # reference set.c HRD scales
        bw.write(4, br_scale)
        bw.write(4, cpb_scale)
        bw.write_ue(max(1, sps.hrd_bitrate >> (6 + br_scale)) - 1)
        bw.write_ue(max(1, sps.hrd_cpb_size >> (4 + cpb_scale)) - 1)
        bw.write1(int(sps.hrd_cbr))
        bw.write(5, sps.initial_cpb_removal_delay_length - 1)
        bw.write(5, sps.cpb_removal_delay_length - 1)
        bw.write(5, sps.dpb_output_delay_length - 1)
        bw.write(5, 23)                      # time_offset_length
    bw.write1(0)  # vcl_hrd_parameters_present
    if sps.nal_hrd_parameters:
        bw.write1(0)                         # low_delay_hrd
    bw.write1(int(sps.pic_struct_present))
    bw.write1(int(sps.bitstream_restriction))
    if sps.bitstream_restriction:
        bw.write1(1)   # motion_vectors_over_pic_boundaries
        bw.write_ue(0)  # max_bytes_per_pic_denom
        bw.write_ue(0)  # max_bits_per_mb_denom
        bw.write_ue(16)  # log2_max_mv_length_horizontal
        bw.write_ue(16)  # log2_max_mv_length_vertical
        bw.write_ue(sps.max_num_reorder_frames)
        bw.write_ue(sps.max_dec_frame_buffering)


@dataclass
class PPS:
    """Picture parameter set (spec 7.3.2.2; reference set.c:479)."""
    id: int = 0
    sps_id: int = 0
    cabac: bool = True
    pic_order_present: bool = False
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control: bool = True
    constrained_intra_pred: bool = False
    redundant_pic_cnt: bool = False
    transform_8x8_mode: bool = False
    second_chroma_qp_index_offset: int = 0
    # whether to emit the trailing (more_rbsp_data) part
    high_extras: bool = False


def pps_init(p: P.Params, sps: SPS, pps_id: int = 0) -> PPS:
    pps = PPS(id=pps_id, sps_id=sps.id)
    pps.cabac = p.cabac
    pps.num_ref_idx_l0_active = max(1, p.frame_reference)
    pps.num_ref_idx_l1_active = 1
    pps.weighted_pred = p.analyse.weighted_pred > 0
    pps.weighted_bipred_idc = (2 if p.bframe and p.analyse.weighted_bipred
                               else 0)
    pps.pic_init_qp = 26
    pps.chroma_qp_index_offset = p.analyse.chroma_qp_offset
    pps.constrained_intra_pred = p.constrained_intra
    pps.transform_8x8_mode = p.analyse.transform_8x8
    pps.high_extras = (pps.transform_8x8_mode
                       or p.cqm_preset != P.CQM_FLAT
                       or pps.second_chroma_qp_index_offset
                       != pps.chroma_qp_index_offset)
    return pps


def pps_write(pps: PPS) -> bytes:
    bw = BitWriter()
    bw.write_ue(pps.id)
    bw.write_ue(pps.sps_id)
    bw.write1(int(pps.cabac))
    bw.write1(int(pps.pic_order_present))
    bw.write_ue(0)  # num_slice_groups - 1
    bw.write_ue(pps.num_ref_idx_l0_active - 1)
    bw.write_ue(pps.num_ref_idx_l1_active - 1)
    bw.write1(int(pps.weighted_pred))
    bw.write(2, pps.weighted_bipred_idc)
    bw.write_se(pps.pic_init_qp - 26)
    bw.write_se(pps.pic_init_qs - 26)
    bw.write_se(pps.chroma_qp_index_offset)
    bw.write1(int(pps.deblocking_filter_control))
    bw.write1(int(pps.constrained_intra_pred))
    bw.write1(int(pps.redundant_pic_cnt))
    if pps.high_extras:
        bw.write1(int(pps.transform_8x8_mode))
        bw.write1(0)  # pic_scaling_matrix_present
        bw.write_se(pps.second_chroma_qp_index_offset)
    bw.rbsp_trailing()
    return bw.getvalue()


# ------------------------------------------------------------------- SEI
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_FILLER = 3
SEI_FRAME_PACKING = 45
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
SEI_ALTERNATIVE_TRANSFER = 147

_VERSION_UUID = bytes([0x2A, 0x0C, 0x7E, 0x41, 0x9D, 0xB1, 0x45, 0x0F,
                       0x8A, 0x3D, 0x6C, 0x31, 0xD0, 0x8F, 0x22, 0xE4])



def _sei_align(bw: BitWriter) -> None:
    """SEI payload alignment (spec D.1): pad only when not byte-aligned."""
    if bw._nbits:
        bw.rbsp_trailing()

def sei_write(payload_type: int, payload: bytes) -> bytes:
    """Generic SEI message wrapper (spec 7.3.2.3; reference set.c:574)."""
    bw = BitWriter()
    t = payload_type
    while t >= 255:
        bw.write(8, 255)
        t -= 255
    bw.write(8, t)
    n = len(payload)
    while n >= 255:
        bw.write(8, 255)
        n -= 255
    bw.write(8, n)
    for byte in payload:
        bw.write(8, byte)
    bw.rbsp_trailing()
    return bw.getvalue()


def sei_version(p: P.Params, version: str = "") -> bytes:
    """user_data_unregistered SEI with encoder settings (reference
    x264_sei_version_write, set.c:594)."""
    from .. import __version__
    opts = (f"x264-tpu {version or __version__} - TPU-native H.264 encoder"
            f" - options: crf={p.rc.rf_constant} qp={p.rc.qp_constant}"
            f" me=esa subme={p.analyse.subpel_refine}"
            f" keyint={p.keyint_max} deblock={int(p.deblocking_filter)}"
            f" aq={p.rc.aq_mode}:{p.rc.aq_strength}")
    return sei_write(SEI_USER_DATA_UNREGISTERED,
                     _VERSION_UUID + opts.encode() + b"\x00")


def sei_recovery_point(recovery_frame_cnt: int) -> bytes:
    bw = BitWriter()
    bw.write_ue(recovery_frame_cnt)
    bw.write1(1)   # exact_match
    bw.write1(0)   # broken_link
    bw.write(2, 0)  # changing_slice_group
    bw.rbsp_trailing()
    data = bw.getvalue()
    return sei_write(SEI_RECOVERY_POINT, data)


def sei_buffering_period(sps: SPS, initial_cpb_removal_delay: int,
                         initial_cpb_removal_delay_offset: int = 0) -> bytes:
    """Buffering period SEI (spec D.1.1; reference set.c:654). Requires
    HRD parameters in the SPS VUI (written when VBV is configured)."""
    bw = BitWriter()
    bw.write_ue(sps.id)
    bw.write(sps.initial_cpb_removal_delay_length,
             initial_cpb_removal_delay)
    bw.write(sps.initial_cpb_removal_delay_length,
             initial_cpb_removal_delay_offset)
    _sei_align(bw)
    return sei_write(SEI_BUFFERING_PERIOD, bw.getvalue())


def sei_pic_timing(sps: SPS, cpb_removal_delay: int,
                   dpb_output_delay: int, pic_struct: int = 0) -> bytes:
    """Picture timing SEI (spec D.1.2; reference set.c:687)."""
    bw = BitWriter()
    if sps.nal_hrd_parameters:
        bw.write(sps.cpb_removal_delay_length, cpb_removal_delay)
        bw.write(sps.dpb_output_delay_length, dpb_output_delay)
    if sps.pic_struct_present:
        bw.write(4, pic_struct)
    _sei_align(bw)
    return sei_write(SEI_PIC_TIMING, bw.getvalue())


def sei_filler(size: int) -> bytes:
    """Filler payload SEI (reference set.c: filler via NAL_FILLER too)."""
    return sei_write(SEI_FILLER, b"\xff" * max(0, size))


def sei_frame_packing(arrangement_type: int) -> bytes:
    """Frame packing arrangement SEI (spec D.1.25; reference set.c:718,
    --frame-packing). 3=side-by-side, 4=top-bottom, 5=temporal, ..."""
    bw = BitWriter()
    quincunx = arrangement_type == 0     # checkerboard IS quincunx
    bw.write_ue(0)                       # arrangement id
    bw.write1(0)                         # cancel
    bw.write(7, arrangement_type)
    bw.write1(quincunx)                  # quincunx_sampling_flag
    bw.write(6, 0)                       # content_interpretation
    bw.write1(0)                         # spatial_flipping
    bw.write1(0)                         # frame0_flipped
    bw.write1(0)                         # field_views
    bw.write1(arrangement_type == 5)     # current_frame_is_frame0
    bw.write1(0)                         # frame0_self_contained
    bw.write1(0)                         # frame1_self_contained
    if not quincunx and arrangement_type != 5:
        for _ in range(4):
            bw.write(4, 0)               # grid positions
    bw.write(8, 0)                       # arrangement_reserved_byte
    # period 1 = persists; type 5 alternates current_frame_is_frame0
    bw.write_ue(1 if arrangement_type != 5 else 0)   # repetition_period
    bw.write1(0)                         # extension flag
    _sei_align(bw)
    return sei_write(SEI_FRAME_PACKING, bw.getvalue())


def sei_mastering_display(primaries, white_point, max_lum,
                          min_lum) -> bytes:
    """Mastering display colour volume SEI (spec D.1.29; reference
    set.c:804, --mastering-display). primaries: 3 (x,y) GBR pairs in
    0.00002 units; luminance in 0.0001 cd/m2."""
    bw = BitWriter()
    for x, y in primaries:
        bw.write(16, x)
        bw.write(16, y)
    bw.write(16, white_point[0])
    bw.write(16, white_point[1])
    bw.write(32, max_lum)
    bw.write(32, min_lum)
    _sei_align(bw)
    return sei_write(SEI_MASTERING_DISPLAY, bw.getvalue())


def sei_content_light_level(max_cll: int, max_fall: int) -> bytes:
    """Content light level SEI (spec D.1.31; reference set.c:830,
    --cll)."""
    bw = BitWriter()
    bw.write(16, max_cll)
    bw.write(16, max_fall)
    _sei_align(bw)
    return sei_write(SEI_CONTENT_LIGHT_LEVEL, bw.getvalue())


def sei_alternative_transfer(transfer: int) -> bytes:
    """Alternative transfer characteristics SEI (spec D.1.32; reference
    set.c:843, --atc-sei)."""
    bw = BitWriter()
    bw.write(8, transfer)
    _sei_align(bw)
    return sei_write(SEI_ALTERNATIVE_TRANSFER, bw.getvalue())
