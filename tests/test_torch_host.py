"""The port's copies of x264_tpu's host modules against the originals.

x264_tpu_torch keeps its own params, SPS/PPS/SEI and slice-header
writers, rate control and logger, so that it imports nothing of x264_tpu.
Each case builds the same input in both packages and asserts the two give
the same values, bytes or QPs; utils/log.py is also a line-for-line copy,
and both Encoders carry a logger at the parameters' level."""

import dataclasses
import inspect

import numpy as np
import pytest

from x264_tpu import params as jp
from x264_tpu.encoder import encoder as jenc
from x264_tpu.encoder import ratecontrol as jrc
from x264_tpu.entropy import sets as jsets
from x264_tpu.entropy import slice_hdr as jsh
from x264_tpu.utils import log as jlog
from x264_tpu_torch import params as tp
from x264_tpu_torch.encoder import encoder as tenc
from x264_tpu_torch.encoder import ratecontrol as trc
from x264_tpu_torch.entropy import sets as tsets
from x264_tpu_torch.entropy import slice_hdr as tsh
from x264_tpu_torch.utils import log as tlog

JAX_SIDE = (jp, jenc, jrc, jsets, jsh)
PORT_SIDE = (tp, tenc, trc, tsets, tsh)


@pytest.mark.parametrize("preset", [None] + jp.PRESET_NAMES)
@pytest.mark.parametrize("tune", [None] + jp.TUNE_NAMES)
def test_param_default_preset_matches(preset, tune):
    assert tp.PRESET_NAMES == jp.PRESET_NAMES
    assert tp.TUNE_NAMES == jp.TUNE_NAMES
    ref = dataclasses.asdict(jp.param_default_preset(preset, tune))
    got = dataclasses.asdict(tp.param_default_preset(preset, tune))
    assert got == ref


PARSE_CASES = [
    [("keyint", "60")],
    [("keyint", "infinite"), ("min-keyint", "5")],
    [("qp", "30")],
    [("crf", "20.5")],
    [("bitrate", "4000"), ("vbv-maxrate", "5000"), ("vbv-bufsize", "8000")],
    [("no-deblock", None)],
    [("deblock", "1:-2")],
    [("analyse", "i4x4,p8x8")],
    [("analyse", "none"), ("ref", "2"), ("bframes", "0")],
    [("no-cabac", None), ("aud", None), ("nal-hrd", "vbr")],
]


@pytest.mark.parametrize("opts", PARSE_CASES,
                         ids=[",".join(k for k, _ in c) for c in PARSE_CASES])
def test_param_parse_matches(opts):
    ref = jp.param_default_preset("medium")
    got = tp.param_default_preset("medium")
    for name, value in opts:
        jp.param_parse(ref, name, value)
        tp.param_parse(got, name, value)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _params(P, case):
    """Three parameter sets that differ in size, preset, rate control,
    VUI / HRD and SEI content."""
    if case == "1080p_medium_cqp":
        p = P.param_default_preset("medium")
        p.width, p.height = 1920, 1080
        p.rc.rc_method, p.rc.qp_constant = P.RC_CQP, 26
    elif case == "720p_veryfast_vbv_hrd":
        p = P.param_default_preset("veryfast", "zerolatency")
        p.width, p.height = 1280, 720
        for name, value in (("bitrate", "3000"), ("vbv-maxrate", "3000"),
                            ("vbv-bufsize", "6000"), ("nal-hrd", "cbr")):
            P.param_parse(p, name, value)
    else:                                   # 360p_slow_film_crf
        p = P.param_default_preset("slow", "film")
        p.width, p.height = 640, 360
        P.param_parse(p, "crf", "19")
        P.param_parse(p, "keyint", "250")
    return p


SET_CASES = ["1080p_medium_cqp", "720p_veryfast_vbv_hrd",
             "360p_slow_film_crf"]


def _headers(side, case):
    P, E, _, S, _ = side
    p = E.validate_parameters(_params(P, case))
    sps = S.sps_init(p, p.sps_id)
    pps = S.pps_init(p, sps, p.sps_id)
    return [S.sps_write(sps), S.pps_write(pps), S.sei_version(p),
            S.sei_recovery_point(3), S.sei_buffering_period(sps, 9000, 0),
            S.sei_pic_timing(sps, 4, 2), S.sei_content_light_level(1000, 400),
            S.sei_alternative_transfer(18)]


@pytest.mark.parametrize("case", SET_CASES)
def test_sets_bytes_match(case):
    assert _headers(PORT_SIDE, case) == _headers(JAX_SIDE, case)


def _slice_bits(side, kind):
    P, E, _, S, H = side
    p = E.validate_parameters(_params(P, "1080p_medium_cqp"))
    sps = S.sps_init(p, p.sps_id)
    pps = S.pps_init(p, sps, p.sps_id)
    sh = H.SliceHeader(sps=sps, pps=pps)
    sh.last_mb = 8159
    sh.qp = 23
    if kind == "idr":
        sh.slice_type, sh.idr, sh.idr_pic_id = H.SLICE_TYPE_I, True, 3
        ref_idc = 3
    elif kind == "i":
        sh.slice_type, sh.frame_num, sh.poc_lsb = H.SLICE_TYPE_I, 5, 10
        sh.alpha_c0_offset, sh.beta_offset = 2, -2
        ref_idc = 3
    else:
        sh.slice_type, sh.frame_num, sh.poc_lsb = H.SLICE_TYPE_P, 6, 12
        sh.qp = 29
        sh.num_ref_idx_l0_active, sh.num_ref_idx_override = 2, True
        sh.disable_deblocking_filter_idc = 1
        ref_idc = 2
    bw = H.slice_header_write(sh, ref_idc)
    nbits = bw.bit_pos
    bw.rbsp_trailing()
    return nbits, bw.getvalue()


@pytest.mark.parametrize("kind", ["idr", "i", "p"])
def test_slice_header_bits_match(kind):
    assert _slice_bits(PORT_SIDE, kind) == _slice_bits(JAX_SIDE, kind)


def _qp_sequence(side, method):
    P, E, R, _, _ = side
    p = P.param_default_preset("medium")
    p.width, p.height = 1280, 720
    if method == "cqp":
        p.rc.rc_method, p.rc.qp_constant = P.RC_CQP, 24
    elif method == "crf":
        P.param_parse(p, "crf", "21")
    elif method == "abr":
        P.param_parse(p, "bitrate", "2500")
    else:                                   # abr + vbv
        for name, value in (("bitrate", "2500"), ("vbv-maxrate", "3000"),
                            ("vbv-bufsize", "3000")):
            P.param_parse(p, name, value)
    p = E.validate_parameters(p)
    rc = R.RateControl(p)
    rng = np.random.default_rng(77)
    types = [E.TYPE_IDR, E.TYPE_P, E.TYPE_P, E.TYPE_B, E.TYPE_P, E.TYPE_I,
             E.TYPE_P, E.TYPE_B, E.TYPE_P, E.TYPE_P, E.TYPE_IDR, E.TYPE_P]
    qps = []
    for i, ftype in enumerate(types):
        qp = rc.start(ftype, -1, frame_idx=i)
        bits = int(rng.integers(20_000, 400_000))
        satd = float(rng.integers(50_000, 900_000))
        rc.end(ftype, bits, satd, qp)
        qps.append(qp)
    return qps


@pytest.mark.parametrize("method", ["cqp", "crf", "abr", "abr_vbv"])
def test_ratecontrol_qp_sequence_matches(method):
    ref = _qp_sequence(JAX_SIDE, method)
    assert _qp_sequence(PORT_SIDE, method) == ref
    assert len(set(ref)) > 1 or method == "cqp"


def test_log_module_is_a_copy_and_filters_alike(capsys):
    assert inspect.getsource(tlog) == inspect.getsource(jlog)
    seen = {}
    for side, mod in (("jax", jlog), ("port", tlog)):
        got = []
        lg = mod.Logger(mod.LOG_WARNING, lambda lv, m: got.append((lv, m)))
        for emit in (lg.error, lg.warning, lg.info, lg.debug):
            emit(emit.__name__)
        lg.set_sink(None)
        lg.error("to stderr")
        seen[side] = (got, capsys.readouterr().err)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [(0, "error"), (1, "warning")]
    assert seen["port"][1] == "x264-tpu [error]: to stderr\n"


def test_encoder_log_follows_log_level():
    """Encoder.log (x264_tpu Encoder.__init__) at p.log_level."""
    p = tp.param_default_preset("ultrafast")
    p.width, p.height, p.log_level = 64, 48, tlog.LOG_DEBUG
    enc = tenc.Encoder(p, device="cpu")
    assert isinstance(enc.log, tlog.Logger)
    assert enc.log.level == tlog.LOG_DEBUG
