"""Encoder parameter system: defaults, presets, tunes, profiles, string parser.

TPU-native re-design of the reference x264 configuration surface
(reference: x264.h:312-622 `x264_param_t`; common/base.c:344 defaults;
base.c:489-609 presets; base.c:611-706 tunes; base.c:749 profiles;
base.c:886 `x264_param_parse`).

Unlike the reference's flat C struct, parameters live in typed dataclasses.
The string key/value parser accepts the same ~200 CLI keys so existing x264
command lines keep working.

The port's own copy of `x264_tpu/params.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional


# ---------------------------------------------------------------------------
# Enums / constants (reference: x264.h:193-298)
# ---------------------------------------------------------------------------

# Motion estimation methods
ME_DIA, ME_HEX, ME_UMH, ME_ESA, ME_TESA = 0, 1, 2, 3, 4
ME_NAMES = ["dia", "hex", "umh", "esa", "tesa"]

# Direct MV prediction
DIRECT_NONE, DIRECT_SPATIAL, DIRECT_TEMPORAL, DIRECT_AUTO = 0, 1, 2, 3
DIRECT_NAMES = ["none", "spatial", "temporal", "auto"]

# B-adapt
B_ADAPT_NONE, B_ADAPT_FAST, B_ADAPT_TRELLIS = 0, 1, 2

# B-pyramid
B_PYRAMID_NONE, B_PYRAMID_STRICT, B_PYRAMID_NORMAL = 0, 1, 2
B_PYRAMID_NAMES = ["none", "strict", "normal"]

# Weighted prediction for P-frames
WEIGHTP_NONE, WEIGHTP_SIMPLE, WEIGHTP_SMART = 0, 1, 2

# Rate control methods
RC_CQP, RC_CRF, RC_ABR = 0, 1, 2

# Adaptive quantization modes
AQ_NONE, AQ_VARIANCE, AQ_AUTOVARIANCE, AQ_AUTOVARIANCE_BIASED = 0, 1, 2, 3

# Log levels
LOG_NONE, LOG_ERROR, LOG_WARNING, LOG_INFO, LOG_DEBUG = -1, 0, 1, 2, 3

# Analysis partition flags (reference: x264.h:243-252)
ANALYSE_I4x4 = 0x0001
ANALYSE_I8x8 = 0x0002
ANALYSE_PSUB16x16 = 0x0010
ANALYSE_PSUB8x8 = 0x0020
ANALYSE_BSUB16x16 = 0x0100

# CQM presets
CQM_FLAT, CQM_JVT, CQM_CUSTOM = 0, 1, 2

# Chroma samplings / colourspaces (subset of reference x264.h:222-241)
CSP_I400, CSP_I420, CSP_I422, CSP_I444 = 0x01, 0x02, 0x05, 0x08
CSP_NV12, CSP_YV12 = 0x03, 0x04
CSP_NAMES = {
    "i400": CSP_I400, "i420": CSP_I420, "i422": CSP_I422, "i444": CSP_I444,
    "nv12": CSP_NV12, "yv12": CSP_YV12,
}
# chroma_format_idc per CSP family
CHROMA_FORMAT_IDC = {CSP_I400: 0, CSP_I420: 1, CSP_NV12: 1, CSP_YV12: 1,
                     CSP_I422: 2, CSP_I444: 3}

# Profiles (reference: common/base.h PROFILE_*)
PROFILE_BASELINE, PROFILE_MAIN, PROFILE_HIGH = 66, 77, 100
PROFILE_HIGH10, PROFILE_HIGH422, PROFILE_HIGH444 = 110, 122, 244
PROFILE_NAMES = {
    "baseline": PROFILE_BASELINE, "main": PROFILE_MAIN, "high": PROFILE_HIGH,
    "high10": PROFILE_HIGH10, "high422": PROFILE_HIGH422,
    "high444": PROFILE_HIGH444,
}

# NAL HRD
NAL_HRD_NONE, NAL_HRD_VBR, NAL_HRD_CBR = 0, 1, 2

# Hierarchical scale constants (reference: common/base.h:136-144)
BFRAME_MAX = 16
REF_MAX = 16
THREAD_MAX = 128
LOOKAHEAD_MAX = 250

QP_MAX_SPEC = 51  # 8-bit H.264 spec max
QP_BD_OFFSET = {8: 0, 10: 12}  # qp range extension for high bit depth

PRESET_NAMES = ["ultrafast", "superfast", "veryfast", "faster", "fast",
                "medium", "slow", "slower", "veryslow", "placebo"]
TUNE_NAMES = ["film", "animation", "grain", "stillimage", "psnr", "ssim",
              "fastdecode", "zerolatency", "touhou"]


class ParamError(ValueError):
    """Raised for bad parameter names/values (x264.h:666-668 equivalents)."""


# ---------------------------------------------------------------------------
# Parameter dataclasses
# ---------------------------------------------------------------------------

@dataclass
class VUIParams:
    """VUI (video usability info) — reference x264.h:421-434, doc/vui.txt."""
    sar_width: int = 0
    sar_height: int = 0
    overscan: int = 0          # 0=undef, 1=show, 2=crop
    vidformat: int = 5         # undef
    fullrange: int = -1        # -1 = from input
    colorprim: int = 2         # undef
    transfer: int = 2          # undef
    colmatrix: int = -1        # -1 = from input
    chroma_loc: int = 0


@dataclass
class AnalyseParams:
    """Analysis / mode-decision knobs — reference x264.h:437-470."""
    intra: int = ANALYSE_I4x4 | ANALYSE_I8x8
    inter: int = (ANALYSE_I4x4 | ANALYSE_I8x8 |
                  ANALYSE_PSUB16x16 | ANALYSE_BSUB16x16)
    transform_8x8: bool = True
    weighted_pred: int = WEIGHTP_SMART
    weighted_bipred: bool = True
    direct_mv_pred: int = DIRECT_SPATIAL
    chroma_qp_offset: int = 0
    me_method: int = ME_HEX
    me_range: int = 16
    mv_range: int = -1         # set from level
    mv_range_thread: int = -1
    subpel_refine: int = 7     # subme 0..11
    chroma_me: bool = True
    mixed_references: bool = True
    trellis: int = 1
    fast_pskip: bool = True
    dct_decimate: bool = True
    noise_reduction: int = 0
    psy: bool = True
    psy_rd: float = 1.0
    psy_trellis: float = 0.0
    luma_deadzone: tuple = (21, 11)   # (inter, intra)
    psnr: bool = False
    ssim: bool = False


@dataclass
class RCParams:
    """Rate-control — reference x264.h:472-519, doc/ratecontrol.txt."""
    rc_method: int = RC_CRF
    qp_constant: int = -1
    qp_min: int = 0
    qp_max: int = 10_000       # clamped at validate to spec range
    qp_step: int = 4
    bitrate: int = 0
    rf_constant: float = 23.0
    rf_constant_max: float = 0.0
    rate_tolerance: float = 1.0
    vbv_max_bitrate: int = 0
    vbv_buffer_size: int = 0
    vbv_buffer_init: float = 0.9
    ip_factor: float = 1.4
    pb_factor: float = 1.3
    filler: bool = False
    aq_mode: int = AQ_VARIANCE
    aq_strength: float = 1.0
    mb_tree: bool = True
    lookahead: int = 40
    # 2-pass
    stat_write: bool = False
    stat_out: str = "x264_2pass.log"
    stat_read: bool = False
    stat_in: str = "x264_2pass.log"
    qcompress: float = 0.6
    qblur: float = 0.5
    complexity_blur: float = 20.0
    zones: list = field(default_factory=list)   # list of Zone
    demote_simple_moving: bool = False


@dataclass
class Zone:
    """RC override for a frame range (reference x264.h:300-310)."""
    start: int = 0
    end: int = 0
    force_qp: int = 0          # 0 = off
    bitrate_factor: float = 1.0


@dataclass
class Params:
    """Top-level encoder parameters (reference x264_param_t, x264.h:312-622)."""
    # Threads / determinism (on TPU these select batching strategies)
    threads: int = 0                 # 0 = auto
    lookahead_threads: int = 0
    sliced_threads: bool = False     # band-parallel single-frame mode
    deterministic: bool = True
    cpu_independent: bool = False
    sync_lookahead: int = -1

    # Video properties
    csp: int = CSP_I420
    width: int = 0
    height: int = 0
    bitdepth: int = 8
    level_idc: int = -1
    frame_total: int = 0
    vui: VUIParams = field(default_factory=VUIParams)
    fps_num: int = 25
    fps_den: int = 1
    timebase_num: int = 0
    timebase_den: int = 0
    vfr_input: bool = True

    # Bitstream
    frame_reference: int = 3
    dpb_size: int = -1
    keyint_max: int = 250
    keyint_min: int = -1             # auto
    scenecut_threshold: int = 40
    intra_refresh: bool = False
    bframe: int = 3
    bframe_adaptive: int = B_ADAPT_FAST
    bframe_bias: int = 0
    bframe_pyramid: int = B_PYRAMID_NORMAL
    open_gop: bool = False
    bluray_compat: bool = False
    avcintra_class: int = 0
    deblocking_filter: bool = True
    deblocking_filter_alphac0: int = 0
    deblocking_filter_beta: int = 0
    cabac: bool = True
    cabac_init_idc: int = 0
    interlaced: bool = False
    tff: bool = True
    constrained_intra: bool = False
    fake_interlaced: bool = False

    cqm_preset: int = CQM_FLAT
    cqm_4iy: Optional[list] = None
    cqm_4py: Optional[list] = None
    cqm_4ic: Optional[list] = None
    cqm_4pc: Optional[list] = None
    cqm_8iy: Optional[list] = None
    cqm_8py: Optional[list] = None
    cqm_8ic: Optional[list] = None
    cqm_8pc: Optional[list] = None

    analyse: AnalyseParams = field(default_factory=AnalyseParams)
    rc: RCParams = field(default_factory=RCParams)

    # Slicing
    slice_max_size: int = 0
    slice_max_mbs: int = 0
    slice_min_mbs: int = 0
    slice_count: int = 0
    slice_count_max: int = 0

    # Muxing / NAL
    aud: bool = False
    repeat_headers: bool = True
    annexb: bool = True
    sps_id: int = 0
    nal_hrd: int = NAL_HRD_NONE
    pic_struct: bool = False
    crop_rect: tuple = (0, 0, 0, 0)
    frame_packing: int = -1
    alternative_transfer: int = 2
    mastering_display: str = ""      # "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)"
    content_light_level: str = ""    # "maxcll,maxfall"
    stitchable: bool = False
    opencl: bool = False             # reference GPU-lookahead toggle; TPU build
                                     # runs lookahead on-device always
    dump_yuv: str = ""
    full_recon: bool = False
    # per-NAL callback for low-latency streaming (reference x264.h:584:
    # nalu_process): called as nalu_process(encoder, nal, opaque) for
    # every finished NAL of a frame, before encode() returns it
    nalu_process: object = None

    # Logging
    log_level: int = LOG_INFO
    psz_clbin_file: str = ""

    # TPU-specific extensions (no reference equivalent)
    tpu_backend: str = "auto"        # 'auto' | 'xla' | 'pallas' | 'numpy'
    tpu_batch_frames: int = 1        # frames analysed per device dispatch
    force_pcm: bool = False          # debug: emit I_PCM macroblocks only

    # ---- derived helpers -------------------------------------------------
    @property
    def fps(self) -> Fraction:
        return Fraction(self.fps_num, max(1, self.fps_den))

    @property
    def chroma_format_idc(self) -> int:
        return CHROMA_FORMAT_IDC.get(self.csp, 1)

    @property
    def qp_bd_offset(self) -> int:
        return QP_BD_OFFSET.get(self.bitdepth, 0)

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    def copy(self) -> "Params":
        return dataclasses.replace(
            self,
            vui=dataclasses.replace(self.vui),
            analyse=dataclasses.replace(self.analyse),
            rc=dataclasses.replace(self.rc),
        )


# ---------------------------------------------------------------------------
# Presets (reference: common/base.c:489-609). Values verified against the
# reference table; medium == defaults.
# ---------------------------------------------------------------------------

def _apply_preset(p: Params, preset: str) -> None:
    if preset.isdigit() and int(preset) < len(PRESET_NAMES):
        preset = PRESET_NAMES[int(preset)]
    preset = preset.lower()
    a, rc = p.analyse, p.rc
    if preset == "ultrafast":
        p.frame_reference = 1
        p.scenecut_threshold = 0
        p.deblocking_filter = False
        p.cabac = False
        p.bframe = 0
        a.intra = 0
        a.inter = 0
        a.transform_8x8 = False
        a.me_method = ME_DIA
        a.subpel_refine = 0
        rc.aq_mode = AQ_NONE
        a.mixed_references = False
        a.trellis = 0
        p.bframe_adaptive = B_ADAPT_NONE
        rc.mb_tree = False
        a.weighted_pred = WEIGHTP_NONE
        a.weighted_bipred = False
        rc.lookahead = 0
    elif preset == "superfast":
        a.inter = ANALYSE_I8x8 | ANALYSE_I4x4
        a.me_method = ME_DIA
        a.subpel_refine = 1
        p.frame_reference = 1
        a.mixed_references = False
        a.trellis = 0
        rc.mb_tree = False
        a.weighted_pred = WEIGHTP_SIMPLE
        rc.lookahead = 0
    elif preset == "veryfast":
        a.subpel_refine = 2
        p.frame_reference = 1
        a.mixed_references = False
        a.trellis = 0
        a.weighted_pred = WEIGHTP_SIMPLE
        rc.lookahead = 10
    elif preset == "faster":
        a.mixed_references = False
        p.frame_reference = 2
        a.subpel_refine = 4
        a.weighted_pred = WEIGHTP_SIMPLE
        rc.lookahead = 20
    elif preset == "fast":
        p.frame_reference = 2
        a.subpel_refine = 6
        a.weighted_pred = WEIGHTP_SIMPLE
        rc.lookahead = 30
    elif preset == "medium":
        pass
    elif preset == "slow":
        a.subpel_refine = 8
        p.frame_reference = 5
        a.direct_mv_pred = DIRECT_AUTO
        a.trellis = 2
        rc.lookahead = 50
    elif preset == "slower":
        a.me_method = ME_UMH
        a.subpel_refine = 9
        p.frame_reference = 8
        p.bframe_adaptive = B_ADAPT_TRELLIS
        a.direct_mv_pred = DIRECT_AUTO
        a.inter |= ANALYSE_PSUB8x8
        a.trellis = 2
        rc.lookahead = 60
    elif preset == "veryslow":
        a.me_method = ME_UMH
        a.subpel_refine = 10
        a.me_range = 24
        p.frame_reference = 16
        p.bframe_adaptive = B_ADAPT_TRELLIS
        a.direct_mv_pred = DIRECT_AUTO
        a.inter |= ANALYSE_PSUB8x8
        a.trellis = 2
        p.bframe = 8
        rc.lookahead = 60
    elif preset == "placebo":
        a.me_method = ME_TESA
        a.subpel_refine = 11
        a.me_range = 24
        p.frame_reference = 16
        p.bframe_adaptive = B_ADAPT_TRELLIS
        a.direct_mv_pred = DIRECT_AUTO
        a.inter |= ANALYSE_PSUB8x8
        a.fast_pskip = False
        a.trellis = 2
        p.bframe = 16
        rc.lookahead = 60
    else:
        raise ParamError(f"invalid preset '{preset}'")


def _apply_tune(p: Params, tune: str) -> None:
    """Reference: base.c:611-704; only one psy tune may be combined with
    non-psy tunes (fastdecode/zerolatency)."""
    import re
    psy_used = 0
    a, rc = p.analyse, p.rc
    for t in [s for s in re.split(r"[,./\-+]", tune) if s]:
        t = t.lower()
        psy_tunes = {"film", "animation", "grain", "stillimage", "psnr",
                     "ssim", "touhou"}
        if t in psy_tunes:
            psy_used += 1
            if psy_used > 1:
                continue  # warning in reference; ignore extras
        if t == "film":
            p.deblocking_filter_alphac0 = -1
            p.deblocking_filter_beta = -1
            a.psy_trellis = 0.15
        elif t == "animation":
            p.frame_reference = (p.frame_reference * 2
                                 if p.frame_reference > 1 else 1)
            p.deblocking_filter_alphac0 = 1
            p.deblocking_filter_beta = 1
            a.psy_rd = 0.4
            rc.aq_strength = 0.6
            p.bframe += 2
        elif t == "grain":
            p.deblocking_filter_alphac0 = -2
            p.deblocking_filter_beta = -2
            a.psy_trellis = 0.25
            a.dct_decimate = False
            rc.pb_factor = 1.1
            rc.ip_factor = 1.1
            rc.aq_strength = 0.5
            a.luma_deadzone = (6, 6)
            rc.qcompress = 0.8
        elif t == "stillimage":
            p.deblocking_filter_alphac0 = -3
            p.deblocking_filter_beta = -3
            a.psy_rd = 2.0
            a.psy_trellis = 0.7
            rc.aq_strength = 1.2
        elif t == "psnr":
            rc.aq_mode = AQ_NONE
            a.psy = False
        elif t == "ssim":
            rc.aq_mode = AQ_AUTOVARIANCE
            a.psy = False
        elif t == "fastdecode":
            p.deblocking_filter = False
            p.cabac = False
            a.weighted_bipred = False
            a.weighted_pred = WEIGHTP_NONE
        elif t == "zerolatency":
            rc.lookahead = 0
            p.sync_lookahead = 0
            p.bframe = 0
            p.sliced_threads = True
            p.vfr_input = False
            rc.mb_tree = False
        elif t == "touhou":
            p.frame_reference = (p.frame_reference * 2
                                 if p.frame_reference > 1 else 1)
            p.deblocking_filter_alphac0 = -1
            p.deblocking_filter_beta = -1
            a.psy_trellis = 0.2
            rc.aq_strength = 1.3
            if a.inter & ANALYSE_PSUB16x16:
                a.inter |= ANALYSE_PSUB8x8
        else:
            raise ParamError(f"invalid tune '{t}'")


def param_default() -> Params:
    return Params()


def param_default_preset(preset: Optional[str] = None,
                         tune: Optional[str] = None) -> Params:
    """Reference: x264_param_default_preset (base.c:706)."""
    p = Params()
    if preset:
        _apply_preset(p, preset)
    if tune:
        _apply_tune(p, tune)
    return p


def param_apply_fastfirstpass(p: Params) -> None:
    """Reference: x264_param_apply_fastfirstpass (base.c:717)."""
    if p.rc.stat_write and not p.rc.stat_read:
        p.frame_reference = 1
        p.analyse.transform_8x8 = False
        p.analyse.inter = 0
        p.analyse.me_method = ME_DIA
        p.analyse.subpel_refine = min(2, p.analyse.subpel_refine)
        p.analyse.trellis = 0
        p.analyse.fast_pskip = True


def param_apply_profile(p: Params, profile: Optional[str]) -> None:
    """Reference: x264_param_apply_profile (base.c:749). Restricts features
    to fit the requested profile."""
    if not profile:
        return
    prof = PROFILE_NAMES.get(profile.lower())
    if prof is None:
        raise ParamError(f"invalid profile '{profile}'")
    if p.bitdepth > 8 and prof < PROFILE_HIGH10:
        raise ParamError(f"{profile} profile doesn't support a bit depth of "
                         f"{p.bitdepth}")
    if p.csp >= CSP_I422 and prof < PROFILE_HIGH422:
        raise ParamError(f"{profile} profile doesn't support 4:2:2 / 4:4:4")
    if prof == PROFILE_BASELINE:
        p.analyse.transform_8x8 = False
        p.cqm_preset = CQM_FLAT
        p.bframe = 0
        p.cabac = False
        p.interlaced = False
        p.bluray_compat = False
        if p.rc.rc_method == RC_CRF and p.rc.rf_constant == 0:
            raise ParamError("baseline profile doesn't support lossless")
        p.analyse.weighted_pred = WEIGHTP_NONE
    elif prof == PROFILE_MAIN:
        p.analyse.transform_8x8 = False
        p.cqm_preset = CQM_FLAT
        if p.rc.rc_method == RC_CRF and p.rc.rf_constant == 0:
            raise ParamError("main profile doesn't support lossless")


# ---------------------------------------------------------------------------
# String parser — x264_param_parse (base.c:886). Same option keys as the CLI.
# ---------------------------------------------------------------------------

def _parse_bool(v: str) -> bool:
    s = v.lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off", "auto"):
        return False
    raise ParamError(f"bad boolean value '{v}'")


def _parse_enum(v: str, names) -> int:
    s = v.lower()
    if isinstance(names, dict):
        if s in names:
            return names[s]
    else:
        if s in names:
            return names.index(s)
    try:
        return int(v)
    except ValueError:
        raise ParamError(f"bad enum value '{v}'") from None


def param_parse(p: Params, name: str, value: Optional[str] = None) -> None:
    """Set one parameter by its CLI string key (reference base.c:886).

    Supports `no-` prefixed names for booleans. Raises ParamError on unknown
    names / bad values (X264_PARAM_BAD_NAME / BAD_VALUE analogue).
    """
    name = name.replace("_", "-")
    invert = False
    if name.startswith("no-"):
        name, invert = name[3:], True
    if value is None:
        value = "false" if invert else "true"
    elif invert:
        value = "false" if _parse_bool(value) else "true"
    a, rc, vui = p.analyse, p.rc, p.vui

    def b() -> bool:
        return _parse_bool(value)

    def i() -> int:
        return int(value, 0)

    def f() -> float:
        return float(value)

    if name == "threads":
        p.threads = 0 if value == "auto" else i()
    elif name == "lookahead-threads":
        p.lookahead_threads = 0 if value == "auto" else i()
    elif name == "sliced-threads":
        p.sliced_threads = b()
    elif name == "deterministic":
        p.deterministic = b()
    elif name == "cpu-independent":
        p.cpu_independent = b()
    elif name == "sync-lookahead":
        p.sync_lookahead = -1 if value == "auto" else i()
    elif name in ("level", "level-idc"):
        if value in ("auto", "-1"):
            p.level_idc = -1
        elif "." in value or (value.isdigit() and int(value) < 10):
            p.level_idc = int(round(float(value) * 10))
        else:
            p.level_idc = i()
    elif name == "bluray-compat":
        p.bluray_compat = b()
    elif name == "avcintra-class":
        p.avcintra_class = i()
    elif name == "sar":
        w, _, h = value.partition(":")
        if not h:
            w, _, h = value.partition("/")
        vui.sar_width, vui.sar_height = int(w), int(h)
    elif name == "overscan":
        vui.overscan = _parse_enum(value, ["undef", "show", "crop"])
    elif name == "videoformat":
        vui.vidformat = _parse_enum(
            value, ["component", "pal", "ntsc", "secam", "mac", "undef"])
    elif name == "fullrange":
        vui.fullrange = 1 if _parse_bool(value) else 0
    elif name == "colorprim":
        vui.colorprim = _parse_enum(value, [
            "", "bt709", "undef", "", "bt470m", "bt470bg", "smpte170m",
            "smpte240m", "film", "bt2020", "smpte428", "smpte431",
            "smpte432"])
    elif name == "transfer":
        vui.transfer = _parse_enum(value, [
            "", "bt709", "undef", "", "bt470m", "bt470bg", "smpte170m",
            "smpte240m", "linear", "log100", "log316", "iec61966-2-4",
            "bt1361e", "iec61966-2-1", "bt2020-10", "bt2020-12",
            "smpte2084", "smpte428", "arib-std-b67"])
    elif name == "colormatrix":
        vui.colmatrix = _parse_enum(value, [
            "gbr", "bt709", "undef", "", "fcc", "bt470bg", "smpte170m",
            "smpte240m", "ycgco", "bt2020nc", "bt2020c", "smpte2085",
            "chroma-derived-nc", "chroma-derived-c", "ictcp"])
    elif name == "chromaloc":
        vui.chroma_loc = i()
    elif name == "fps":
        if "/" in value:
            n, d = value.split("/")
            p.fps_num, p.fps_den = int(n), int(d)
        else:
            fr = Fraction(value).limit_denominator(1 << 30)
            p.fps_num, p.fps_den = fr.numerator, fr.denominator
    elif name == "ref":
        p.frame_reference = i()
    elif name == "dpb-size":
        p.dpb_size = i()
    elif name in ("keyint", "keyint-max"):
        p.keyint_max = 1 << 30 if value == "infinite" else i()
    elif name in ("min-keyint", "keyint-min"):
        p.keyint_min = -1 if value == "auto" else i()
    elif name == "scenecut":
        p.scenecut_threshold = i() if value not in ("false", "no", "0") else 0
    elif name == "intra-refresh":
        p.intra_refresh = b()
    elif name == "bframes":
        p.bframe = i()
    elif name == "b-adapt":
        p.bframe_adaptive = i()
    elif name == "b-bias":
        p.bframe_bias = i()
    elif name == "b-pyramid":
        p.bframe_pyramid = _parse_enum(value, B_PYRAMID_NAMES)
    elif name == "open-gop":
        p.open_gop = b()
    elif name == "nf":
        p.deblocking_filter = not b()
    elif name in ("filter", "deblock"):
        if value in ("0", "false", "no", "off"):
            p.deblocking_filter = False
        else:
            p.deblocking_filter = True
            parts = value.split(":") if ":" in value else value.split(",")
            if parts and parts[0].lstrip("-").isdigit():
                p.deblocking_filter_alphac0 = int(parts[0])
                p.deblocking_filter_beta = (int(parts[1]) if len(parts) > 1
                                            else int(parts[0]))
    elif name == "slice-max-size":
        p.slice_max_size = i()
    elif name == "slice-max-mbs":
        p.slice_max_mbs = i()
    elif name == "slice-min-mbs":
        p.slice_min_mbs = i()
    elif name == "slices":
        p.slice_count = i()
    elif name == "slices-max":
        p.slice_count_max = i()
    elif name == "cabac":
        p.cabac = b()
    elif name == "cabac-idc":
        p.cabac_init_idc = i()
    elif name == "interlaced":
        p.interlaced = b()
    elif name == "tff":
        p.interlaced = b(); p.tff = True
    elif name == "bff":
        p.interlaced = b(); p.tff = False
    elif name == "constrained-intra":
        p.constrained_intra = b()
    elif name == "cqm":
        if value.lower() == "flat":
            p.cqm_preset = CQM_FLAT
        elif value.lower() == "jvt":
            p.cqm_preset = CQM_JVT
        else:
            raise ParamError(f"bad cqm preset '{value}'")
    elif name == "log":
        p.log_level = i()
    elif name == "dump-yuv":
        p.dump_yuv = value
    elif name == "analyse" or name == "partitions":
        a.intra = a.inter = 0
        for part in value.split(","):
            part = part.strip()
            if part == "none":
                pass
            elif part == "all":
                a.intra = ANALYSE_I4x4 | ANALYSE_I8x8
                a.inter = (ANALYSE_I4x4 | ANALYSE_I8x8 | ANALYSE_PSUB16x16 |
                           ANALYSE_PSUB8x8 | ANALYSE_BSUB16x16)
            elif part == "i4x4":
                a.intra |= ANALYSE_I4x4; a.inter |= ANALYSE_I4x4
            elif part == "i8x8":
                a.intra |= ANALYSE_I8x8; a.inter |= ANALYSE_I8x8
            elif part == "p8x8":
                a.inter |= ANALYSE_PSUB16x16
            elif part == "p4x4":
                a.inter |= ANALYSE_PSUB8x8
            elif part == "b8x8":
                a.inter |= ANALYSE_BSUB16x16
            else:
                raise ParamError(f"bad partition '{part}'")
    elif name == "8x8dct":
        a.transform_8x8 = b()
    elif name == "weightb":
        a.weighted_bipred = b()
    elif name == "weightp":
        a.weighted_pred = i()
    elif name == "direct":
        a.direct_mv_pred = _parse_enum(value, DIRECT_NAMES)
    elif name == "chroma-qp-offset":
        a.chroma_qp_offset = i()
    elif name == "me":
        a.me_method = _parse_enum(value, ME_NAMES)
    elif name == "merange":
        a.me_range = i()
    elif name == "mvrange":
        a.mv_range = i()
    elif name == "mvrange-thread":
        a.mv_range_thread = i()
    elif name == "subme":
        a.subpel_refine = i()
    elif name == "psy-rd":
        parts = value.split(":") if ":" in value else value.split(",")
        a.psy_rd = float(parts[0])
        a.psy_trellis = float(parts[1]) if len(parts) > 1 else 0.0
    elif name == "psy":
        a.psy = b()
    elif name == "chroma-me":
        a.chroma_me = b()
    elif name == "mixed-refs":
        a.mixed_references = b()
    elif name == "trellis":
        a.trellis = i()
    elif name == "fast-pskip":
        a.fast_pskip = b()
    elif name == "dct-decimate":
        a.dct_decimate = b()
    elif name == "deadzone-inter":
        a.luma_deadzone = (i(), a.luma_deadzone[1])
    elif name == "deadzone-intra":
        a.luma_deadzone = (a.luma_deadzone[0], i())
    elif name == "nr":
        a.noise_reduction = i()
    elif name == "bitrate":
        rc.bitrate = i(); rc.rc_method = RC_ABR
    elif name in ("qp", "qp-constant"):
        rc.qp_constant = i(); rc.rc_method = RC_CQP
    elif name == "crf":
        rc.rf_constant = f(); rc.rc_method = RC_CRF
    elif name == "crf-max":
        rc.rf_constant_max = f()
    elif name == "rc-lookahead":
        rc.lookahead = i()
    elif name == "qpmin":
        rc.qp_min = i()
    elif name == "qpmax":
        rc.qp_max = i()
    elif name == "qpstep":
        rc.qp_step = i()
    elif name == "ratetol":
        rc.rate_tolerance = f()
    elif name == "vbv-maxrate":
        rc.vbv_max_bitrate = i()
    elif name == "vbv-bufsize":
        rc.vbv_buffer_size = i()
    elif name == "vbv-init":
        rc.vbv_buffer_init = f()
    elif name == "ipratio":
        rc.ip_factor = f()
    elif name == "pbratio":
        rc.pb_factor = f()
    elif name == "aq-mode":
        rc.aq_mode = i()
    elif name == "aq-strength":
        rc.aq_strength = f()
    elif name == "pass":
        v = i()
        rc.stat_write = bool(v & 1)
        rc.stat_read = bool(v & 2)
    elif name == "stats":
        rc.stat_in = rc.stat_out = value
    elif name == "qcomp":
        rc.qcompress = f()
    elif name == "mbtree":
        rc.mb_tree = b()
    elif name == "qblur":
        rc.qblur = f()
    elif name == "cplxblur":
        rc.complexity_blur = f()
    elif name == "zones":
        rc.zones = []
        for z in value.split("/"):
            se, _, opt = z.partition(",")
            start, _, end = se.partition(",")
            # format: start,end,q=qp or start,end,b=factor
            fields = z.split(",")
            zone = Zone(start=int(fields[0]), end=int(fields[1]))
            for kv in fields[2:]:
                k, _, v2 = kv.partition("=")
                if k == "q":
                    zone.force_qp = int(v2)
                elif k == "b":
                    zone.bitrate_factor = float(v2)
                else:
                    param_parse(p, k, v2)   # full zone param overrides: TODO
            rc.zones.append(zone)
    elif name == "psnr":
        a.psnr = b()
    elif name == "ssim":
        a.ssim = b()
    elif name == "aud":
        p.aud = b()
    elif name == "sps-id":
        p.sps_id = i()
    elif name == "global-header":
        p.repeat_headers = not b()
    elif name == "repeat-headers":
        p.repeat_headers = b()
    elif name == "annexb":
        p.annexb = b()
    elif name == "force-cfr":
        p.vfr_input = not b()
    elif name == "nal-hrd":
        p.nal_hrd = _parse_enum(value, ["none", "vbr", "cbr"])
    elif name == "filler":
        rc.filler = b()
    elif name == "pic-struct":
        p.pic_struct = b()
    elif name == "fake-interlaced":
        p.fake_interlaced = b()
    elif name == "frame-packing":
        p.frame_packing = i()
    elif name == "mastering-display":
        p.mastering_display = value
    elif name == "cll":
        p.content_light_level = value
    elif name == "atc-sei":
        p.alternative_transfer = i()
    elif name == "alternative-transfer":
        p.alternative_transfer = i()
    elif name == "stitchable":
        p.stitchable = b()
    elif name == "opencl":
        p.opencl = b()
    elif name == "bitdepth" or name == "output-depth":
        p.bitdepth = i()
    elif name == "input-csp":
        p.csp = _parse_enum(value, CSP_NAMES)
    # TPU-specific
    elif name == "tpu-backend":
        p.tpu_backend = value
    elif name == "tpu-batch-frames":
        p.tpu_batch_frames = i()
    else:
        raise ParamError(f"unknown parameter '{name}'")
