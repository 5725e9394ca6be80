"""The CABAC half of the port against x264_tpu: the host copies
(cabac_tables, csrc/cabac.cpp, cabac_host), the CABAC-only device
functions with a QP map that varies per MB (i_stage_pack_cabac,
p_effqp_core, p_decisions_dict), the branch of the P pipeline without
P_8x8 that CABAC frames take (5 refine lanes, 3 RD candidates, 2 chroma
slots, trellis on), and both Encoders end to end at 64x48 on three clips:
all-intra CABAC x3, IPPP CABAC at CQP 26 x5 (two references live from
frame 2) and IPPP CABAC at CRF 23 with AQ x5 (MB-tree off).

Every output here is an integer or a byte string: every comparison is
exact. Each stage of the P pipeline is fed the JAX outputs of the stage
before it, as tests/test_torch_inter.py does for the P_8x8 side."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_inter_e2e import moving_frames
from test_torch_inter import LAM, ME_RANGE, _eq, _ref_entry, _t
from test_torch_pframe import encode_all
from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu.encoder.encoder import TYPE_IDR, TYPE_P
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu.entropy import cabac_host as jhost
from x264_tpu.entropy import cabac_tables as jtab
from x264_tpu.ops import trellis as jtrellis
from x264_tpu.ops.tables import chroma_qp
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.encoder.encoder import Encoder
from x264_tpu_torch.entropy import cabac_host as thost
from x264_tpu_torch.entropy import cabac_tables as ttab
from x264_tpu_torch.ops import trellis as ttrellis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402


# -------------------------------------------------------------- host copies
def test_cabac_tables_match_x264_tpu():
    names = [k for k, val in vars(jtab).items()
             if isinstance(val, np.ndarray)]
    assert {"CTX_INIT_I", "CTX_INIT_PB", "RANGE_TAB_LPS", "TRANS_IDX_MPS",
            "TRANS_IDX_LPS"} <= set(names)
    for k in names:
        a, b = getattr(jtab, k), getattr(ttab, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_cabac_cpp_is_a_byte_copy_and_builds_in_the_port():
    """csrc/cabac.cpp equals native/cabac.cpp byte for byte, and the
    port's loader builds its own copy into x264_tpu_torch/_build/."""
    with open(os.path.join(ROOT, "native", "cabac.cpp"), "rb") as f:
        ref = f.read()
    with open(thost._SRC, "rb") as f:
        got = f.read()
    assert got == ref
    pkg = os.path.join(ROOT, "x264_tpu_torch")
    assert thost._SRC == os.path.join(pkg, "csrc", "cabac.cpp")
    lib = thost._load()
    assert lib is thost._load()
    built = [f for f in os.listdir(os.path.join(pkg, "_build"))
             if f.startswith("libcabac-") and f.endswith(".so")]
    assert built


@pytest.mark.parametrize("slice_i,model", [(True, 0), (False, 0), (False, 1),
                                           (False, 2)])
def test_init_states_match_x264_tpu(slice_i, model):
    for qp in (0, 17, 26, 40, 51, 60):
        ref = jhost.init_states(slice_i, qp, model)
        got = thost.init_states(slice_i, qp, model)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def _seeded_slice(seed, slice_i, mbw=5, mbh=4):
    """Decision and level arrays of one slice, as the finalize functions
    hand them to the writer: sparse levels, a QP that moves from MB to MB,
    and for P slices a mix of skip, inter (three partition shapes, two
    references) and intra MBs."""
    rng = np.random.default_rng(seed)
    n = mbw * mbh

    def sparse(shape, p, lo=-6, hi=7):
        return (rng.integers(lo, hi, shape) * (rng.random(shape) < p)) \
            .astype(np.int16)

    is_intra = np.ones(n, np.uint8) if slice_i else \
        (rng.random(n) < 0.3).astype(np.uint8)
    skip = np.zeros(n, np.uint8) if slice_i else \
        ((rng.random(n) < 0.25) & (is_intra == 0)).astype(np.uint8)
    is_i4 = ((rng.random(n) < 0.5) & (is_intra > 0)).astype(np.uint8)
    luma_ac = sparse((n, 16, 16), 0.15)
    luma_ac[skip > 0] = 0
    luma_ac[rng.random(n) < 0.2] = 0
    quad_nz = (luma_ac != 0).any(2).reshape(n, 4, 4).any(2)
    cbp_q = (quad_nz.astype(np.int32) << np.arange(4)[None]).sum(1)
    i16 = (is_intra > 0) & (is_i4 == 0)
    luma_ac[i16, :, 0] = 0                     # I16 blocks carry AC only
    cbp16 = np.where((luma_ac[:, :, 1:] != 0).any((1, 2)), 15, 0)
    cbp_luma = np.where(i16, cbp16, cbp_q)
    cdc = sparse((n, 2, 4), 0.3)
    cac = sparse((n, 8, 16), 0.1)
    cac[:, :, 0] = 0
    cdc[skip > 0] = 0
    cac[skip > 0] = 0
    cac[rng.random(n) < 0.5] = 0
    cbp_chroma = np.where((cac != 0).any((1, 2)), 2,
                          np.where((cdc != 0).any((1, 2)), 1, 0))
    kw = dict(
        skip=skip, is_intra=is_intra, i16_mode=rng.integers(0, 4, n),
        chroma_mode=rng.integers(0, 4, n), cbp_luma=cbp_luma,
        cbp_chroma=cbp_chroma, qp_mb=rng.integers(22, 31, n),
        mvd=rng.integers(-40, 41, (n, 2)),
        luma_dc=sparse((n, 16), 0.4, -20, 21) * i16[:, None],
        luma_ac=luma_ac, chroma_dc=cdc, chroma_ac=cac,
        mvd1=rng.integers(-9, 10, (n, 2)), part_mode=rng.integers(0, 3, n),
        is_i4=is_i4, i4_modes=rng.integers(0, 9, (n, 16)),
        refidx=rng.integers(0, 2, n), n_refs=1 if slice_i else 2)
    return (slice_i, mbw, mbh, 26), kw


@pytest.mark.parametrize("slice_i", [True, False], ids=["I", "P"])
def test_encode_slice_cabac_matches_x264_tpu(slice_i):
    args, kw = _seeded_slice(3, slice_i)
    ref = jhost.encode_slice_cabac(*args, **kw)
    got = thost.encode_slice_cabac(*args, **kw)
    assert isinstance(got, bytes) and len(got) > 100
    assert got == ref


# ----------------------------------------------- I frame: the packing stage
@pytest.mark.parametrize("seed", [0, 1])
def test_i_stage_pack_cabac_matches_x264_tpu(seed):
    """Seeded sparse levels; a third of the MBs are I_4x4 and a third of
    those carry no residual, so they inherit the QP of the last MB that
    coded an mb_qp_delta (the first MB of the slice: the slice QP)."""
    rng = np.random.default_rng(seed)
    mbw, mbh = 7, 4
    n = mbw * mbh

    def sparse(shape, p):
        return (rng.integers(-9, 10, shape) * (rng.random(shape) < p)) \
            .astype(np.int32)

    coeffs = {"dc": sparse((n, 4, 4), 0.3), "ac": sparse((n, 16, 4, 4), 0.1),
              "udc": sparse((n, 2, 2), 0.3), "vdc": sparse((n, 2, 2), 0.3),
              "uac": sparse((n, 4, 4, 4), 0.05),
              "vac": sparse((n, 4, 4, 4), 0.05)}
    i4_mask = rng.random((mbh, mbw)) < 0.5
    i4_mask[0, 0] = True
    empty = i4_mask.reshape(-1) & (rng.random(n) < 0.6)
    empty[0] = True
    for k in ("ac", "udc", "vdc", "uac", "vac"):
        coeffs[k][empty] = 0
    qp_mb = rng.integers(20, 34, (mbh, mbw)).astype(np.int32)
    ref = jintra.i_stage_pack_cabac(
        {k: jnp.asarray(a) for k, a in coeffs.items()}, jnp.asarray(i4_mask),
        jnp.asarray(qp_mb), 27, mbw=mbw, mbh=mbh)
    got = tintra.i_stage_pack_cabac(
        {k: _t(a) for k, a in coeffs.items()}, _t(i4_mask), _t(qp_mb), 27,
        mbw=mbw, mbh=mbh)
    for i, (a, b) in enumerate(zip(ref, got)):
        _eq(a, b, f"output {i}")
    eff = got[4].numpy()
    assert eff[0] == 27 and (eff != qp_mb.reshape(-1)).sum() >= 3


# ------------------------------------------- P frame: the branch without P8x8
def _build_cabac_ctx():
    """Frame 2 of the moving clip at 64x48 against references frame 1
    (weighted) and frame 0, a per-MB QP of 20..33, and the JAX outputs of
    every stage at the settings a CABAC frame runs: p8x8 off, trellis on."""
    w, h = 64, 48
    frames = moving_frames(3, w, h, seed=3)
    y, u, v = frames[2]
    mbw, mbh = w // 16, h // 16
    refs = [_ref_entry(frames[1]), _ref_entry(frames[0])]
    rng = np.random.default_rng(12)
    qp_mb = rng.integers(20, 34, (mbh, mbw)).astype(np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb, 0), np.int32)
    c = dict(mbw=mbw, mbh=mbh, y=y, u=u, v=v, refs=refs, qp_mb=qp_mb,
             qpc_mb=qpc_mb)
    jy = jnp.asarray(y)
    c["fullpel"] = [jinter.p_fullpel_core(
        jy, r[0]["y_pad"], LAM, me_range=ME_RANGE, shapes=True,
        me_seeded=True) for r in refs]
    c["wo"] = [(100, 7), (128, 0)]
    c["subpel"] = [jinter.p_subpel_core(
        jy, r[0]["hpel"], f[0], f[1], LAM, jnp.asarray(c["wo"][k][0]),
        jnp.asarray(c["wo"][k][1]), me_range=ME_RANGE, partitions=True,
        p8x8=False, weighted=True, return_cands=True)
        for k, (r, f) in enumerate(zip(refs, c["fullpel"]))]
    c["select"] = jinter.p_me_select(c["subpel"][0], c["subpel"][1],
                                     jnp.asarray(True))
    c["intra"] = jinter.p_intra_core(jy, jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(qp_mb), i4=True)
    cands = c["select"][6]
    c["rd"] = jinter.p_rd_core(
        jy, cands[0], cands[1], c["fullpel"][0][1], jnp.asarray(qp_mb),
        jnp.asarray(True), c["intra"][0], mbw=mbw, mbh=mbh, p8x8=False,
        two_refs=True, intra_rd=True)
    c["trl"] = jtrellis.frame_ctx_costs(False, 26, cat=2)
    return c


@pytest.fixture(scope="module")
def cctx():
    return _build_cabac_ctx()


def _xfrm_inputs(c, conv, port):
    (inter_cost, _, mvq, _, _, refidx, _) = c["select"]
    part_mode, pred_y, mv_parts, is_intra_rd = c["rd"]
    i16, cm, i4m, use_i4, best = c["intra"]
    refs = [r[1 if port else 0] for r in c["refs"]]
    vals = [c["y"], c["u"], c["v"], refs[0]["cuv_pad"], refs[1]["cuv_pad"],
            inter_cost, pred_y, mvq, part_mode, mv_parts, refidx, i16, cm,
            i4m, use_i4, best, c["qp_mb"], c["qpc_mb"]]
    return [conv(np.asarray(a)) for a in vals], conv(np.asarray(is_intra_rd))


def _jax_xfrm(c, trellis=True):
    args, ov = _xfrm_inputs(c, jnp.asarray, False)
    trl = tuple(jnp.asarray(t) for t in c["trl"]) if trellis else None
    return jinter.p_xfrm_core(
        *args, None, None, trl, ov, mbw=c["mbw"], mbh=c["mbh"],
        partitions=True, p8x8=False, two_refs=True, i4=True, intra_in_p=True,
        pir=False, nr=False, trellis=trellis, decimate=True,
        me_range=ME_RANGE)


def _port_xfrm(c, trellis=True):
    args, ov = _xfrm_inputs(c, _t, True)
    return tinter.p_xfrm_core(
        *args, ov, ttrellis.frame_ctx_costs(False, 26, cat=2) if trellis
        else None, mbw=c["mbw"], mbh=c["mbh"], two_refs=True, decimate=True,
        p8x8=False)


def _jax_merge(c, xm):
    return jinter.p_merge_core(
        jnp.asarray(c["y"]), jnp.asarray(c["u"]), jnp.asarray(c["v"]),
        jnp.asarray(c["qp_mb"]), jnp.asarray(c["qpc_mb"]), xm, mbw=c["mbw"],
        mbh=c["mbh"], partitions=True, p8x8=False, two_refs=True, i4=True,
        intra_in_p=True, use_pallas=False)


def test_subpel_refine_all_five_lanes_matches_x264_tpu(cctx):
    mvs_j, mvp_j = cctx["fullpel"][0]
    hpel_j = cctx["refs"][0][0]["hpel"]
    ref = jinter.subpel_refine_all(hpel_j, jnp.asarray(cctx["y"]), mvs_j,
                                   LAM, ME_RANGE, mvp_q=mvp_j, p8x8=False)
    got = tinter.subpel_refine_all(_t(hpel_j), _t(cctx["y"]),
                                   {k: _t(v) for k, v in mvs_j.items()},
                                   LAM, ME_RANGE, mvp_q=_t(mvp_j), p8x8=False)
    assert got[3].shape[0] == 4 and len(got[4]) == 4
    for i in (0, 1, 2, 3, 5):
        _eq(ref[i], got[i], f"output {i}")
    for a, b in zip(ref[4], got[4]):
        _eq(a, b, "pred_parts")


@pytest.mark.parametrize("k", [0, 1], ids=["weighted", "unweighted"])
def test_p_subpel_core_without_p8x8_matches_x264_tpu(cctx, k):
    mvs_j, mvp_j = cctx["fullpel"][k]
    w, o = cctx["wo"][k]
    ref = cctx["subpel"][k]
    got = tinter.p_subpel_core(
        _t(cctx["y"]), _t(cctx["refs"][k][0]["hpel"]),
        {kk: _t(v) for kk, v in mvs_j.items()}, _t(mvp_j), LAM, w, o,
        me_range=ME_RANGE, return_cands=True, p8x8=False)
    assert set(ref) == set(got)
    for key in ref:
        _eq(ref[key], got[key], key)
    assert got["cand_pred"].shape[0] == 3 and got["cand_mv"].shape[0] == 3
    assert int(got["part_mode"].max()) <= 2


@pytest.mark.parametrize("live", [True, False])
def test_p_rd_core_without_p8x8_matches_x264_tpu(cctx, live):
    """Three candidates, priced at a per-MB lambda2 (the QP map varies)."""
    cands = cctx["select"][6]
    mvp = cctx["fullpel"][0][1]
    ref = cctx["rd"] if live else jinter.p_rd_core(
        jnp.asarray(cctx["y"]), cands[0], cands[1], mvp,
        jnp.asarray(cctx["qp_mb"]), jnp.asarray(False), cctx["intra"][0],
        mbw=cctx["mbw"], mbh=cctx["mbh"], p8x8=False, two_refs=True,
        intra_rd=True)
    got = tinter.p_rd_core(_t(cctx["y"]), _t(cands[0]),
                           _t(cands[1]), _t(mvp), _t(cctx["qp_mb"]), live,
                           _t(cctx["intra"][0]), mbw=cctx["mbw"],
                           mbh=cctx["mbh"], two_refs=True)
    for i, (a, b) in enumerate(zip(ref, got)):
        _eq(a, b, f"output {i}")
    assert int(got[0].max()) <= 2


@pytest.mark.parametrize("trellis", [True, False],
                         ids=["trellis", "deadzone"])
def test_p_xfrm_core_without_p8x8_matches_x264_tpu(cctx, trellis):
    """Two chroma partition slots, and with trellis the requantized inter
    luma at the per-MB QP; the trellis must change some level against the
    deadzone quantizer, or the case would not see it."""
    ref = _jax_xfrm(cctx, trellis)
    got = _port_xfrm(cctx, trellis)
    for key in got:
        _eq(ref[key], got[key], key)
    if trellis:
        plain = _port_xfrm(cctx, False)
        assert (plain["lv"] != got["lv"]).any()
        assert plain["lv"].abs().sum() > got["lv"].abs().sum()


def test_p_merge_effqp_decisions_match_x264_tpu(cctx):
    """p_merge_core on the no-P8x8 dict, then the CABAC tail on it:
    p_effqp_core, p_decisions_dict (int16 / uint8) and p_decisions_core."""
    mbw, mbh = cctx["mbw"], cctx["mbh"]
    jcm = _jax_merge(cctx, _jax_xfrm(cctx))
    tcm = tinter.p_merge_core(
        _t(cctx["y"]), _t(cctx["u"]), _t(cctx["v"]), _t(cctx["qp_mb"]),
        _t(cctx["qpc_mb"]), _port_xfrm(cctx), mbw=mbw, mbh=mbh,
        two_refs=True, i4=True)
    for key in tcm:
        _eq(jcm[key], tcm[key], key)
    assert int(tcm["p8x8_n"]) == 0
    jdec, jeff = jinter.p_decisions_core(jcm, 26, mbw=mbw, mbh=mbh)
    tdec, teff = tinter.p_decisions_core(tcm, 26, mbw=mbw, mbh=mbh)
    _eq(jeff, teff, "eff_qp")
    _eq(jinter.p_effqp_core(jcm, 26, mbw=mbw, mbh=mbh),
        tinter.p_effqp_core(tcm, 26, mbw=mbw, mbh=mbh))
    assert set(jdec) == set(tdec)
    for key in jdec:
        assert str(np.asarray(jdec[key]).dtype) == \
            str(tdec[key].numpy().dtype), key
        _eq(jdec[key], tdec[key], key)


def _seeded_cm(seed, mbw=8, mbh=5):
    """A p_merge_core-shaped dict from a seed: skip runs, inter MBs with
    and without residual, I16x16 MBs and I_4x4 MBs with and without
    residual, so the decoder-carried QP chain takes every branch."""
    rng = np.random.default_rng(seed)
    n = mbw * mbh
    is_intra = rng.random(n) < 0.3
    is_i4 = is_intra & (rng.random(n) < 0.5)
    skip = ~is_intra & (rng.random(n) < 0.3)
    cbp_luma = rng.integers(0, 16, n) * (rng.random(n) < 0.5)
    cbp_chroma = rng.integers(0, 3, n) * (rng.random(n) < 0.5)
    cbp_luma[skip] = 0
    cbp_chroma[skip] = 0

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    return {
        "is_intra": is_intra.reshape(mbh, mbw), "is_i4_f": is_i4,
        "skip": skip, "cbp_luma": cbp_luma.astype(np.int32),
        "cbp_chroma": cbp_chroma.astype(np.int32),
        "qp": ints(18, 40, n), "lv": ints(-300, 300, (n, 16, 4, 4)),
        "cdc_blk": ints(-50, 50, (n, 2, 2, 2)),
        "cac_blk": ints(-50, 50, (n, 2, 4, 4, 4)),
        "dc_blk": ints(-200, 200, (n, 4, 4)),
        "i16_mode": ints(0, 4, (mbh, mbw)),
        "chroma_mode": ints(0, 4, (mbh, mbw)),
        "part_mode": ints(0, 3, n), "mvd": ints(-200, 200, (n, 2)),
        "mvd2": ints(-200, 200, (n, 2)), "mvd23": ints(-9, 9, (n, 2, 2)),
        "i4_modes": ints(0, 9, (n, 16)), "refidx": ints(0, 2, n)}


@pytest.mark.parametrize("i4", [True, False], ids=["i4", "no_i4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_p_effqp_and_decisions_on_seeded_dict(seed, i4):
    cm = _seeded_cm(seed)
    if not i4:
        cm["i4_modes"] = None
        cm["is_i4_f"] = np.zeros_like(cm["is_i4_f"])
    jcm = {k: None if a is None else jnp.asarray(a) for k, a in cm.items()}
    tcm = {k: None if a is None else _t(a) for k, a in cm.items()}
    jeff = jinter.p_effqp_core(jcm, 29, mbw=8, mbh=5)
    teff = tinter.p_effqp_core(tcm, 29, mbw=8, mbh=5)
    _eq(jeff, teff)
    eff = teff.numpy()
    assert (eff != cm["qp"]).sum() >= 5 and (eff == cm["qp"]).sum() >= 5
    jdec = jinter.p_decisions_dict(jcm, jeff, mbw=8, mbh=5)
    tdec = tinter.p_decisions_dict(tcm, teff, mbw=8, mbh=5)
    assert set(jdec) == set(tdec)
    for key in jdec:
        assert str(np.asarray(jdec[key]).dtype) == \
            str(tdec[key].numpy().dtype), key
        _eq(jdec[key], tdec[key], key)


# ------------------------------------------------------ both Encoders, e2e
def cabac_params(preset, w, h, mode):
    """Preset medium (trellis 1, deblock, I_4x4, 2 references, weightp),
    CABAC, no B frames; `mode` picks keyint and rate control."""
    p = preset("medium")
    p.width, p.height = w, h
    p.cabac = True
    p.bframe = 0
    p.full_recon = True
    p.keyint_max = 1 if mode == "intra" else 250
    if mode == "crf_aq":
        p.rc.rc_method = 1          # CRF: AQ stays on
        p.rc.rf_constant = 23.0
        p.rc.mb_tree = False
    else:
        p.rc.rc_method = 0
        p.rc.qp_constant = 26
    return p


# name -> number of frames of the moving 64x48 clip
E2E = {"intra": 3, "cqp": 5, "crf_aq": 5}


@pytest.fixture(scope="module", params=list(E2E))
def clip(request):
    mode = request.param
    w, h = 64, 48
    frames = moving_frames(E2E[mode], w, h)
    jax_enc = JaxEncoder(cabac_params(jax_preset, w, h, mode))
    ref = encode_all(jax_enc, frames)
    enc = Encoder(cabac_params(param_default_preset, w, h, mode),
                  device="cpu")
    assert enc.p.cabac and enc.p.analyse.trellis == 1
    assert bool(enc.p.rc.aq_mode) == (mode == "crf_aq")
    qp_maps = []
    if mode == "crf_aq":
        from x264_tpu_torch.encoder import frame_encode as tfe
        orig = tfe.build_qp_maps

        def spy(*a, **k):
            out = orig(*a, **k)
            qp_maps.append(out[0].numpy().copy())
            return out
        for mod in (tintra, tinter):
            mod.build_qp_maps = spy
    try:
        got = encode_all(enc, frames)
    finally:
        if mode == "crf_aq":
            for mod in (tintra, tinter):
                mod.build_qp_maps = orig
    return dict(name=mode, w=w, h=h, n=len(frames), ref=ref, got=got,
                jax_enc=jax_enc, enc=enc, qp_maps=qp_maps)


def test_cabac_stream_bytes_match_x264_tpu(clip):
    want = [TYPE_IDR] * clip["n"] if clip["name"] == "intra" else \
        [TYPE_IDR] + [TYPE_P] * (clip["n"] - 1)
    assert clip["got"][2] == want == clip["ref"][2]
    assert clip["got"][0] == clip["ref"][0]
    if clip["name"] == "crf_aq":
        # AQ really moved the QP inside every frame
        assert len(clip["qp_maps"]) == clip["n"]
        assert all(len(np.unique(m)) > 1 for m in clip["qp_maps"])


def test_cabac_reconstruction_matches_x264_tpu(clip):
    assert len(clip["got"][1]) == clip["n"]
    for i, (a, b) in enumerate(zip(clip["ref"][1], clip["got"][1])):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c],
                                          err_msg=f"frame {i} plane {c}")


def test_cabac_mb_stats_match_x264_tpu(clip):
    js, ts = clip["jax_enc"].stats, clip["enc"].stats
    assert ts.get("mb") == js.get("mb")
    assert ts["qp_sum"] == js["qp_sum"]
    assert ts["bytes_by_type"] == js["bytes_by_type"]
    assert ts.get("weightp_frames") == js.get("weightp_frames")
    if clip["name"] != "intra":
        mb = ts["mb"]["P"]
        assert mb["8x8"] == 0 and mb["16x8"] + mb["8x16"] > 0
        assert ts.get("weightp_frames", 0) > 0


def test_refdec_decodes_cabac_stream_to_its_recon(clip):
    decoded = refdec.Decoder().decode(clip["got"][0])
    assert len(decoded) == clip["n"]
    for i, (d, r) in enumerate(zip(decoded, clip["got"][1])):
        for c in range(3):
            np.testing.assert_array_equal(d[c], r[c],
                                          err_msg=f"frame {i} plane {c}")


def test_avdec_decodes_cabac_stream_to_its_recon(clip, tmp_path):
    avdec = os.path.join(ROOT, "tools", "avdec")
    if not os.path.exists(avdec):
        pytest.skip("tools/avdec not built (needs gcc and libavcodec)")
    bs, out = tmp_path / "port.264", tmp_path / "port.yuv"
    bs.write_bytes(clip["got"][0])
    subprocess.run([avdec, str(bs), str(out)], check=True,
                   capture_output=True, timeout=120)
    raw = np.frombuffer(out.read_bytes(), np.uint8)
    w, h = clip["w"], clip["h"]
    fsz = w * h * 3 // 2
    assert raw.size == clip["n"] * fsz
    for i, rec in enumerate(clip["got"][1]):
        f = raw[i * fsz:(i + 1) * fsz]
        planes = [f[:w * h].reshape(h, w),
                  f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                  f[w * h * 5 // 4:].reshape(h // 2, w // 2)]
        for c in range(3):
            np.testing.assert_array_equal(planes[c], rec[c],
                                          err_msg=f"frame {i} plane {c}")
