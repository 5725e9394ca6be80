"""The port's P-frame modules against their JAX twins in x264_tpu.

Every stage of the P pipeline at the bench's settings (preset medium,
CAVLC: seeded full-pel ME, 16x8 / 8x16 / 8x8 partitions, two references,
weighted prediction, I_4x4 in P, the subme-7 RD tier, decimation) is fed
the same seeded inputs on both sides, each stage from the JAX outputs of
the stage before it, at 64x48 and 48x32. Every output is an integer:
every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_inter_e2e import moving_frames
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import lookahead as jlook
from x264_tpu.entropy import cavlc_jax
from x264_tpu.ops import deblock as jdeblock
from x264_tpu.ops import mc as jmc
from x264_tpu.ops import warp as jwarp
from x264_tpu.ops.tables import chroma_qp
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import lookahead as tlook
from x264_tpu_torch.entropy import cavlc_dev
from x264_tpu_torch.ops import commit as tcommit
from x264_tpu_torch.ops import deblock as tdeblock
from x264_tpu_torch.ops import warp as twarp

QP = 26
LAM = 6          # max(1, round(2 ** ((26 - 12) / 6)))
ME_RANGE = 16    # medium's merange, under PAD - 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref, got, msg=""):
    np.testing.assert_array_equal(np.asarray(ref),
                                  got.numpy() if isinstance(got, torch.Tensor)
                                  else np.asarray(got), err_msg=msg)


def _ref_entry(planes):
    """(JAX, port) DPB-style reference planes of a source frame."""
    y_pad = jmc.pad_plane(jnp.asarray(planes[0]))
    cuv = jnp.stack([jmc.pad_plane(jnp.asarray(p), jmc.CPAD)
                     for p in planes[1:]])
    j = {"y_pad": y_pad, "hpel": jmc.hpel_planes(y_pad), "cuv_pad": cuv}
    return j, {k: _t(v) for k, v in j.items()}


def _build(w, h):
    """Current frame 2 of the moving clip against references frame 1
    (ref 0, weighted) and frame 0 (ref 1), and the JAX stage outputs."""
    frames = moving_frames(3, w, h, seed=3)
    y, u, v = frames[2]
    mbw, mbh = w // 16, h // 16
    refs = [_ref_entry(frames[1]), _ref_entry(frames[0])]
    qp_mb = np.full((mbh, mbw), QP, np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb, 0), np.int32)
    c = dict(w=w, h=h, mbw=mbw, mbh=mbh, y=y, u=u, v=v, refs=refs,
             qp_mb=qp_mb, qpc_mb=qpc_mb, frames=frames)
    jy = jnp.asarray(y)
    fp = [jinter.p_fullpel_core(jy, r[0]["y_pad"], LAM, me_range=ME_RANGE,
                                shapes=True, me_seeded=True) for r in refs]
    c["fullpel"] = fp
    wo = [(100, 7), (128, 0)]
    c["subpel"] = [jinter.p_subpel_core(
        jy, r[0]["hpel"], f[0], f[1], LAM, jnp.asarray(wo[k][0]),
        jnp.asarray(wo[k][1]), me_range=ME_RANGE, partitions=True,
        p8x8=True, weighted=True, return_cands=True)
        for k, (r, f) in enumerate(zip(refs, fp))]
    c["wo"] = wo
    c["select"] = jinter.p_me_select(c["subpel"][0], c["subpel"][1],
                                     jnp.asarray(True))
    c["intra"] = jinter.p_intra_core(jy, jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(qp_mb), i4=True)
    cands = c["select"][6]
    c["rd"] = jinter.p_rd_core(
        jy, cands[0], cands[1], fp[0][1], jnp.asarray(qp_mb),
        jnp.asarray(True), c["intra"][0], mbw=mbw, mbh=mbh, p8x8=True,
        two_refs=True, intra_rd=True)
    return c


@pytest.fixture(scope="module", params=[(64, 48), (48, 32)],
                ids=["64x48", "48x32"])
def ctx(request):
    return _build(*request.param)


def _xfrm_args(c, is_intra_override, port):
    """p_xfrm_core's positional inputs from the JAX select / intra / rd
    outputs, as JAX arrays or as tensors."""
    conv = _t if port else jnp.asarray
    (inter_cost, _, mvq, _, _, refidx, _) = c["select"]
    part_mode, pred_y, mv_parts, _ = c["rd"]
    i16, cm, i4m, use_i4, best = c["intra"]
    refs = [r[1 if port else 0] for r in c["refs"]]
    vals = [c["y"], c["u"], c["v"], refs[0]["cuv_pad"], refs[1]["cuv_pad"],
            inter_cost, pred_y, mvq, part_mode, mv_parts, refidx, i16, cm,
            i4m, use_i4, best, c["qp_mb"], c["qpc_mb"]]
    return [conv(np.asarray(a)) for a in vals], conv(is_intra_override)


def _jax_xfrm(c, override):
    args, ov = _xfrm_args(c, override, False)
    return jinter.p_xfrm_core(
        *args, None, None, None, ov, mbw=c["mbw"], mbh=c["mbh"],
        partitions=True, p8x8=True, two_refs=True, i4=True, intra_in_p=True,
        pir=False, nr=False, trellis=False, decimate=True,
        me_range=ME_RANGE)


def _port_xfrm(c, override):
    args, ov = _xfrm_args(c, override, True)
    return tinter.p_xfrm_core(*args, ov, mbw=c["mbw"], mbh=c["mbh"],
                              two_refs=True, decimate=True)


# ------------------------------------------------------------ cost helpers
def test_cost_helpers_match_x264_tpu():
    rng = np.random.default_rng(1)
    mvd = rng.integers(-300, 300, (64,)).astype(np.int32)
    _eq(jinter._mv_cost_bits(jnp.asarray(mvd)),
        tinter._mv_cost_bits(_t(mvd)))
    assert [tinter._mv_bits(int(x)) for x in mvd] == \
        np.asarray(jinter._mv_cost_bits(jnp.asarray(mvd))).tolist()
    lv = rng.integers(-2, 3, (5, 16, 16)) * (rng.random((5, 16, 16)) < 0.3)
    lv = lv.astype(np.int32)
    lv[0] = np.clip(lv[0], -1, 1)
    _eq(jinter._decimate_score(jnp.asarray(lv)),
        tinter._decimate_score(_t(lv)))
    pred = rng.integers(0, 256, (2, 3, 16, 16)).astype(np.int32)
    src = rng.integers(0, 256, (3, 16, 16)).astype(np.uint8)
    _eq(jinter._satd16_map(jnp.asarray(pred), jnp.asarray(src)),
        tinter._satd16_map(_t(pred), _t(src)))


def test_lambda2_table_matches_x264_tpu():
    qp = jnp.arange(52, dtype=jnp.int32)
    lam2 = jnp.maximum(1, jnp.round(0.9 * 2.0 ** ((qp - 12) / 3.0))) \
        .astype(jnp.int32)
    _eq(lam2, tinter.LAMBDA2_TAB)


# ---------------------------------------------------------------- group 1-2
def test_search_pair_matches_x264_tpu(ctx):
    lows = [jlook.lowres_plane(jnp.asarray(f[0])) for f in ctx["frames"]]
    for ph in (None, lows[1][1]):
        ref = jlook._search_pair(lows[2][0], lows[1][0], ph)
        got = tlook._search_pair(_t(lows[2][0]), _t(lows[1][0]),
                                 None if ph is None else _t(ph))
        _eq(ref[0], got[0], "sad")
        _eq(ref[1], got[1], "mv")


def test_mb_windows_ref_matches_x264_tpu(ctx):
    """Random offsets in the subpel range and the four corner MBs at
    +-me_range (the widest reach the clamps allow)."""
    mbh, mbw = ctx["mbh"], ctx["mbw"]
    hpel = ctx["refs"][0][0]["hpel"]
    rng = np.random.default_rng(2)
    lo, hi = -ME_RANGE - tinter.SUBPEL_MARG, ME_RANGE - tinter.SUBPEL_MARG
    off = rng.integers(lo, hi + 1, (mbh, mbw, 2)).astype(np.int32)
    for (yy, xx), s in zip(((0, 0), (0, -1), (-1, 0), (-1, -1)),
                           ((-1, -1), (1, -1), (-1, 1), (1, 1))):
        off[yy, xx] = [lo if s[0] < 0 else hi, lo if s[1] < 0 else hi]
    ref = jwarp.mb_windows_ref(hpel, jnp.asarray(off), bs=16, win=24,
                               pad=jmc.PAD)
    got = twarp.mb_windows_ref(_t(hpel), _t(off), bs=16, win=24, pad=jmc.PAD)
    _eq(ref, got.to(torch.int16))
    cp = ctx["refs"][0][0]["cuv_pad"]
    coff = rng.integers(-9, 9, (mbh, mbw, 2)).astype(np.int32)
    _eq(jwarp.mb_windows_ref(cp, jnp.asarray(coff), bs=8, win=9,
                             pad=jmc.CPAD),
        twarp.mb_windows_ref(_t(cp), _t(coff), bs=8, win=9, pad=jmc.CPAD)
        .to(torch.int16))


# ---------------------------------------------------------------- group 4-5
def test_motion_search_seeded_matches_x264_tpu(ctx):
    for k, r in enumerate(ctx["refs"]):
        ref = jinter.motion_search_seeded(r[0]["y_pad"],
                                          jnp.asarray(ctx["y"]), LAM,
                                          ME_RANGE, shapes=True)
        got = tinter.motion_search_seeded(r[1]["y_pad"], _t(ctx["y"]), LAM,
                                          ME_RANGE, shapes=True)
        for key in ("16x16", "16x8", "8x16", "8x8"):
            _eq(ref[key], got[key], f"ref {k} {key}")
        mvs, mvp = tinter.p_fullpel_core(_t(ctx["y"]), r[1]["y_pad"], LAM,
                                         me_range=ME_RANGE)
        _eq(ctx["fullpel"][k][1], mvp, "mvp_q_est")


@pytest.mark.parametrize("variant", ["plain", "masked", "two_refs"])
def test_mv_predictors_matches_x264_tpu(variant):
    rng = np.random.default_rng(4)
    mbh, mbw = 4, 5
    mv = rng.integers(-40, 40, (mbh, mbw, 2)).astype(np.int32)
    mv[1, 2] = 0
    kw_j, kw_t = {}, {}
    if variant != "plain":
        im = rng.random((mbh, mbw)) < 0.7
        kw_j["inter_mask"], kw_t["inter_mask"] = jnp.asarray(im), _t(im)
    if variant == "two_refs":
        rg = rng.integers(0, 2, (mbh, mbw)).astype(np.int32)
        cur = rng.integers(0, 2, (mbh, mbw)).astype(np.int32)
        kw_j.update(ref_grid=jnp.asarray(rg), cur_ref=jnp.asarray(cur))
        kw_t.update(ref_grid=_t(rg), cur_ref=_t(cur))
    ref = jinter.mv_predictors(jnp.asarray(mv), **kw_j)
    got = tinter.mv_predictors(_t(mv), **kw_t)
    _eq(ref[0], got[0], "mvp")
    _eq(ref[1], got[1], "pskip")


@pytest.mark.parametrize("mode", [0, 1, 2, 3, "mixed"])
def test_mv_predictors_part_matches_x264_tpu(mode):
    rng = np.random.default_rng(5)
    mbh, mbw = 3, 4
    if mode == "mixed":
        pm = rng.integers(0, 4, (mbh, mbw)).astype(np.int32)
    else:
        pm = np.full((mbh, mbw), mode, np.int32)
    mv4 = rng.integers(-30, 30, (mbh * 4, mbw * 4, 2)).astype(np.int32)
    mv4[rng.random((mbh * 4, mbw * 4)) < 0.2] = 0
    im = rng.random((mbh, mbw)) < 0.8
    inter4 = np.repeat(np.repeat(im, 4, 0), 4, 1)
    rg = rng.integers(0, 2, (mbh, mbw)).astype(np.int32)
    ref4 = np.repeat(np.repeat(rg, 4, 0), 4, 1)
    for two in (False, True):
        kj = dict(ref4=jnp.asarray(ref4), cur_ref=jnp.asarray(rg)) if two \
            else {}
        kt = dict(ref4=_t(ref4), cur_ref=_t(rg)) if two else {}
        ref = jinter.mv_predictors_part(jnp.asarray(mv4), jnp.asarray(inter4),
                                        jnp.asarray(pm), **kj)
        got = tinter.mv_predictors_part(_t(mv4), _t(inter4), _t(pm), **kt)
        _eq(ref[0], got[0], f"mvp two_refs={two}")
        _eq(ref[1], got[1], f"pskip two_refs={two}")


# ------------------------------------------------------------------ group 6
def test_subpel_windows_and_refine_all_match_x264_tpu(ctx):
    mvs_j, mvp_j = ctx["fullpel"][0]
    hpel_j = ctx["refs"][0][0]["hpel"]
    lane = jnp.stack([mvs_j["16x16"], mvs_j["8x8"][:, :, 2]])
    _eq(jnp.stack([jinter._subpel_windows(hpel_j, m, ME_RANGE)
                   for m in lane]),
        tinter._subpel_windows(_t(hpel_j), _t(lane), ME_RANGE)
        .to(torch.int32))
    ref = jinter.subpel_refine_all(hpel_j, jnp.asarray(ctx["y"]), mvs_j, LAM,
                                   ME_RANGE, mvp_q=mvp_j, p8x8=True)
    got = tinter.subpel_refine_all(_t(hpel_j), _t(ctx["y"]),
                                   {k: _t(v) for k, v in mvs_j.items()},
                                   LAM, ME_RANGE, mvp_q=_t(mvp_j))
    for i in (0, 1, 2, 3, 5):
        _eq(ref[i], got[i], f"output {i}")
    for a, b in zip(ref[4], got[4]):
        _eq(a, b, "pred_parts")
    _eq(jnp.asarray(jinter._subpel_cand_table(3)),
        tinter._subpel_cand_table(3))


@pytest.mark.parametrize("k", [0, 1], ids=["weighted", "unweighted"])
def test_p_subpel_core_matches_x264_tpu(ctx, k):
    """Reference 0 carries the weight (100, 7); reference 1 is unity."""
    mvs_j, mvp_j = ctx["fullpel"][k]
    w, o = ctx["wo"][k]
    ref = ctx["subpel"][k]
    got = tinter.p_subpel_core(
        _t(ctx["y"]), _t(ctx["refs"][k][0]["hpel"]),
        {kk: _t(v) for kk, v in mvs_j.items()}, _t(mvp_j), LAM, w, o,
        me_range=ME_RANGE, return_cands=True)
    assert set(ref) == set(got)
    for key in ref:
        _eq(ref[key], got[key], key)


@pytest.mark.parametrize("valid", [True, False])
def test_p_me_select_matches_x264_tpu(ctx, valid):
    r0, r1 = ctx["subpel"]
    ref = jinter.p_me_select(r0, r1, jnp.asarray(valid))
    got = tinter.p_me_select({k: _t(v) for k, v in r0.items()},
                             {k: _t(v) for k, v in r1.items()}, valid)
    for i in range(6):
        _eq(ref[i], got[i], f"output {i}")
    _eq(ref[6][0], got[6][0], "cand_pred")
    _eq(ref[6][1], got[6][1], "cand_mv")
    if not valid:
        assert not got[5].any()


# ------------------------------------------------------------------ group 7-8
def test_p_intra_core_matches_x264_tpu(ctx):
    got = tinter.p_intra_core(_t(ctx["y"]), _t(ctx["u"]), _t(ctx["v"]),
                              _t(ctx["qp_mb"]), i4=True)
    for i, (a, b) in enumerate(zip(ctx["intra"], got)):
        _eq(a, b, f"output {i}")


@pytest.mark.parametrize("live", [True, False])
def test_p_rd_core_matches_x264_tpu(ctx, live):
    cands = ctx["select"][6]
    mvp = ctx["fullpel"][0][1]
    ref = ctx["rd"] if live else jinter.p_rd_core(
        jnp.asarray(ctx["y"]), cands[0], cands[1], mvp,
        jnp.asarray(ctx["qp_mb"]), jnp.asarray(False), ctx["intra"][0],
        mbw=ctx["mbw"], mbh=ctx["mbh"], p8x8=True, two_refs=True,
        intra_rd=True)
    got = tinter.p_rd_core(_t(ctx["y"]), _t(cands[0]), _t(cands[1]),
                           _t(mvp), _t(ctx["qp_mb"]), live,
                           _t(ctx["intra"][0]), mbw=ctx["mbw"],
                           mbh=ctx["mbh"], two_refs=True)
    for i, (a, b) in enumerate(zip(ref, got)):
        _eq(a, b, f"output {i}")


# ------------------------------------------------------------------ group 9
def test_chroma_mc_warp_matches_x264_tpu(ctx):
    rng = np.random.default_rng(6)
    n = ctx["mbw"] * ctx["mbh"]
    mvq = rng.integers(-4 * ME_RANGE - 3, 4 * ME_RANGE + 4, (n, 2)) \
        .astype(np.int32)
    mvq[0] = [-4 * ME_RANGE - 3, -4 * ME_RANGE - 3]
    mvq[-1] = [4 * ME_RANGE + 3, 4 * ME_RANGE + 3]
    cp = ctx["refs"][1][0]["cuv_pad"]
    _eq(jinter.chroma_mc_warp(cp, jnp.asarray(mvq), ctx["mbh"], ctx["mbw"],
                              ME_RANGE),
        tinter.chroma_mc_warp(_t(cp), _t(mvq), ctx["mbh"], ctx["mbw"]))


def test_p_xfrm_core_matches_x264_tpu(ctx):
    override = np.asarray(ctx["rd"][3])
    ref = _jax_xfrm(ctx, override)
    got = _port_xfrm(ctx, override)
    for key in got:
        _eq(ref[key], got[key], key)


# ------------------------------------------------------------------ group 10
@pytest.mark.parametrize("mask", ["mixed", "empty", "full"])
def test_p_merge_core_matches_x264_tpu(ctx, mask):
    mbh, mbw = ctx["mbh"], ctx["mbw"]
    rng = np.random.default_rng(8)
    ov = {"mixed": rng.random((mbh, mbw)) < 0.4,
          "empty": np.zeros((mbh, mbw), bool),
          "full": np.ones((mbh, mbw), bool)}[mask]
    ov[0, 0] = mask != "empty"
    xj, xt = _jax_xfrm(ctx, ov), _port_xfrm(ctx, ov)
    ref = jinter.p_merge_core(
        jnp.asarray(ctx["y"]), jnp.asarray(ctx["u"]), jnp.asarray(ctx["v"]),
        jnp.asarray(ctx["qp_mb"]), jnp.asarray(ctx["qpc_mb"]), xj, mbw=mbw,
        mbh=mbh, partitions=True, p8x8=True, two_refs=True, i4=True,
        intra_in_p=True, use_pallas=False)
    got = tinter.p_merge_core(_t(ctx["y"]), _t(ctx["u"]), _t(ctx["v"]),
                              _t(ctx["qp_mb"]), _t(ctx["qpc_mb"]), xt,
                              mbw=mbw, mbh=mbh, two_refs=True, i4=True)
    for key in got:
        _eq(ref[key], got[key], key)
    assert int(got["intra_n"]) == int(ov.sum())


def test_mixed_commit_without_intra_equals_skip_branch(ctx):
    """The port launches the mixed commit on every P frame where x264_tpu's
    lax.cond skips it when no MB is intra: with no intra lane, commit_ref
    returns the inter planes and zero levels, which is the skip branch."""
    mbh, mbw = ctx["mbh"], ctx["mbw"]
    xt = _port_xfrm(ctx, np.zeros((mbh, mbw), bool))
    coeffs, rec = tcommit.commit_ref(
        _t(ctx["y"]), _t(ctx["u"]), _t(ctx["v"]), xt["i16_mode"],
        xt["chroma_mode"], _t(ctx["qp_mb"]), _t(ctx["qpc_mb"]), mbw, mbh,
        is_intra=xt["is_intra"], inter_planes=(xt["recon_y"], xt["recon_u"],
                                               xt["recon_v"]),
        i4_mask=xt["i4_mask"], i4_modes=xt["i4_modes"])
    for key, val in coeffs.items():
        assert not val.any(), key
    for a, b in zip(rec, (xt["recon_y"], xt["recon_u"], xt["recon_v"])):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ group 11
def _entropy_inputs(ctx):
    mbh, mbw = ctx["mbh"], ctx["mbw"]
    ov = np.random.default_rng(9).random((mbh, mbw)) < 0.3
    xj = _jax_xfrm(ctx, ov)
    cm = jinter.p_merge_core(
        jnp.asarray(ctx["y"]), jnp.asarray(ctx["u"]), jnp.asarray(ctx["v"]),
        jnp.asarray(ctx["qp_mb"]), jnp.asarray(ctx["qpc_mb"]), xj, mbw=mbw,
        mbh=mbh, partitions=True, p8x8=True, two_refs=True, i4=True,
        intra_in_p=True, use_pallas=False)
    n = mbw * mbh
    cm = dict(cm)
    # some refidx 1 and skipped MBs, so every header branch is written
    cm["refidx"] = jnp.where(~cm["is_intra"].reshape(-1)
                             & (jnp.arange(n) % 3 == 1), 1, cm["refidx"])
    cm["skip"] = cm["skip"] | ((jnp.arange(n) % 5 == 4)
                               & ~cm["is_intra"].reshape(-1))
    args = (cm["skip"], cm["mvd"], cm["cbp_luma"], cm["cbp_chroma"],
            cm["qp"], QP, cm["lv"].reshape(n, 16, 4, 4), cm["cdc_blk"],
            cm["cac_blk"])
    kw = dict(is_intra=cm["is_intra"].reshape(-1),
              i16_mode=cm["i16_mode"].reshape(-1),
              chroma_mode=cm["chroma_mode"].reshape(-1),
              luma_dc=cm["dc_blk"], part_mode=cm["part_mode"],
              mvd2=cm["mvd2"], mvd23=cm["mvd23"], is_i4=cm["is_i4_f"],
              i4_modes=cm["i4_modes"], refidx=cm["refidx"])
    return args, kw


@pytest.mark.parametrize("live", [True, False])
def test_pframe_entropy_matches_x264_tpu(ctx, live):
    mbh, mbw = ctx["mbh"], ctx["mbw"]
    n = mbw * mbh
    args, kw = _entropy_inputs(ctx)
    targs = [_t(a) if not isinstance(a, int) else a for a in args]
    tkw = {k: _t(v) for k, v in kw.items()}
    codes_j = cavlc_jax._pframe_mb_codes(
        *args, mbw=mbw, mbh=mbh, two_refs=True,
        two_refs_live=jnp.asarray(live), **kw)
    codes_t = cavlc_dev._pframe_mb_codes(
        *targs, mbw=mbw, mbh=mbh, two_refs=True, two_refs_live=live, **tkw)
    _eq(np.asarray(codes_j[0]).astype(np.int64), codes_t[0], "codes")
    for i, name in ((1, "lens"), (2, "eff_qp"), (3, "lvl_over"),
                    (4, "trailing")):
        _eq(codes_j[i], codes_t[i], name)
    cap_words = n * 450 // 4
    ref = cavlc_jax.encode_pframe_entropy_dev(
        *args, mbw=mbw, mbh=mbh, cap_words=cap_words, two_refs=True,
        two_refs_live=jnp.asarray(live), **kw)
    got = cavlc_dev.encode_pframe_entropy_dev(
        *targs, mbw=mbw, mbh=mbh, cap_words=cap_words, two_refs=True,
        two_refs_live=live, **tkw)
    bits = int(ref[1])
    assert int(got[1]) == bits
    nw = (bits + 31) // 32
    _eq(np.asarray(ref[0])[:nw].astype(np.int64), got[0][:nw], "words")
    _eq(ref[2], got[2], "eff_qp")


# ------------------------------------------------------------------ group 12
@pytest.mark.parametrize("grain", ["mb", "4x4"])
def test_compute_strengths_matches_x264_tpu(grain):
    rng = np.random.default_rng(10)
    mbh, mbw = 3, 4
    intra = rng.random((mbh, mbw)) < 0.3
    nnz4 = (rng.random((mbh * 4, mbw * 4)) < 0.3).astype(np.int32) * 3
    shape = (mbh, mbw, 2) if grain == "mb" else (mbh * 4, mbw * 4, 2)
    mv = rng.integers(-6, 6, shape).astype(np.int32)
    ref_mb = rng.integers(0, 2, (mbh, mbw)).astype(np.int32)
    for rm in (None, ref_mb):
        ref = jdeblock.compute_strengths(
            jnp.asarray(intra), jnp.asarray(nnz4), jnp.asarray(mv), mbw=mbw,
            mbh=mbh, ref_mb=None if rm is None else jnp.asarray(rm))
        got = tdeblock.compute_strengths(
            _t(intra), _t(nnz4), _t(mv), mbw=mbw, mbh=mbh,
            ref_mb=None if rm is None else _t(rm))
        _eq(ref[0], got[0], "bs_v")
        _eq(ref[1], got[1], "bs_h")


# ------------------------------------------------------------------ group 13
@pytest.mark.parametrize("case", ["fade", "same", "noise"])
def test_weightp_analyse_host_matches_x264_tpu(case):
    rng = np.random.default_rng(11)
    ref = rng.integers(20, 230, (48, 64)).astype(np.uint8)
    cur = {"fade": np.clip(ref.astype(np.int32) * 3 // 4 + 10, 0, 255),
           "same": ref,
           "noise": rng.integers(0, 256, (48, 64))}[case].astype(np.uint8)
    assert (tinter.weightp_analyse_host(cur, ref)
            == jinter.weightp_analyse_host(cur, ref))
