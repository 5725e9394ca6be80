"""The P-frame branches below preset medium and the options around them,
module by module against their JAX twins in x264_tpu, at 48x32:

- noise reduction: `ops.quant.denoise_dct` (also against the scalar rule
  of tests/test_denoise.py) and the host offset update `nr_update`;
- SSIM: `ops.pixel.ssim`, each window's value in float32 on both sides,
  within 1e-6 (XLA may fuse a float32 multiply-add that PyTorch rounds
  twice, and x264_tpu takes the mean in float32, the port in float64);
- the full-pel search of the 16x16 lane alone (`shapes=False`) and the
  periodic intra refresh cap on full-pel dx, seeded and exhaustive;
- `p_subpel_core` without partitions (one lane through subpel_refine_mc);
- `p_rd_core` without its intra candidate;
- the whole P pipeline, `encode_pframe`, against
  `encode_pframe_device(use_pallas=False)` in four configurations that
  between them turn each of partitions, the RD tier, intra in P, periodic
  intra refresh and noise reduction off and on.

Every other output is an integer: those comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_inter_e2e import moving_frames
from x264_tpu.encoder import inter as jinter
from x264_tpu.ops import mc as jmc
from x264_tpu.ops import pixel as jpixel
from x264_tpu.ops import quant as jquant
from x264_tpu.ops.tables import chroma_qp
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.ops import pixel as tpixel
from x264_tpu_torch.ops import quant as tquant

W, H = 48, 32
MBW, MBH = W // 16, H // 16
QP = 26
LAM = 6          # max(1, round(2 ** ((26 - 12) / 6)))
ME_RANGE = 16
SSIM_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref, got, msg=""):
    np.testing.assert_array_equal(
        np.asarray(ref), got.numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), err_msg=msg)


def _ref_entry(planes):
    """(JAX, port) DPB-style reference planes of a source frame."""
    y_pad = jmc.pad_plane(jnp.asarray(planes[0]))
    cuv = jnp.stack([jmc.pad_plane(jnp.asarray(p), jmc.CPAD)
                     for p in planes[1:]])
    j = {"y_pad": y_pad, "hpel": jmc.hpel_planes(y_pad), "cuv_pad": cuv}
    return j, {k: _t(v) for k, v in j.items()}


@pytest.fixture(scope="module")
def fctx():
    """Frame 2 of the moving clip; references frame 1 (ref 0) and frame 0
    (ref 1); a frame of fresh noise in the left half so that MBs turn
    intra."""
    frames = moving_frames(3, W, H, seed=6)
    y, u, v = [p.copy() for p in frames[2]]
    rng = np.random.default_rng(2)
    y[:, :16] = rng.integers(0, 256, (H, 16))
    qp_mb = np.full((MBH, MBW), QP, np.int32)
    return dict(y=y, u=u, v=v, refs=[_ref_entry(frames[1]),
                                     _ref_entry(frames[0])],
                qp_mb=qp_mb, qpc_mb=np.asarray(chroma_qp(qp_mb, 0),
                                               np.int32))


# ---------------------------------------------------------- noise reduction
@pytest.mark.parametrize("seed", [0, 1])
def test_denoise_dct_matches_x264_tpu(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-60, 61, (5, 16, 4, 4)).astype(np.int32)
    off = rng.integers(0, 8, (4, 4)).astype(np.int32)
    ref, rsums = jquant.denoise_dct(jnp.asarray(w), jnp.asarray(off))
    got, sums = tquant.denoise_dct(_t(w), _t(off))
    _eq(ref, got, "levels")
    _eq(rsums, sums, "sums")
    # the scalar rule (common/quant.c denoise_dct) of tests/test_denoise.py
    a = np.abs(w) - off
    np.testing.assert_array_equal(got.numpy(),
                                  np.sign(w) * np.maximum(a, 0))
    np.testing.assert_array_equal(sums.numpy(), np.abs(w).sum((0, 1)))


@pytest.mark.parametrize("count", [400, 1 << 18])
def test_nr_update_matches_x264_tpu(count):
    """Two updates in a row; the larger count crosses 2^18 and halves."""
    rng = np.random.default_rng(count)
    state_j = state_t = (np.zeros((4, 4), np.int64), 0)
    for _ in range(2):
        sums = rng.integers(0, 200000, (4, 4)).astype(np.int64)
        off_j, *state_j = jquant.nr_update(250, sums, count, *state_j)
        off_t, *state_t = tquant.nr_update(250, sums, count, *state_t)
        np.testing.assert_array_equal(off_j, off_t)
        np.testing.assert_array_equal(state_j[0], state_t[0])
        assert state_j[1] == state_t[1]
        assert off_t.dtype == np.int32 and off_t[0, 0] == 0


# ------------------------------------------------------------------ SSIM
@pytest.mark.parametrize("shape,noise", [((32, 48), 20), ((48, 64), 3),
                                         ((36, 60), 40)])
def test_ssim_matches_x264_tpu(shape, noise):
    rng = np.random.default_rng(noise)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, shape), 0,
                255).astype(np.uint8)
    ref = float(jpixel.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = tpixel.ssim(_t(a), _t(b))
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - ref) <= SSIM_TOL
    assert float(tpixel.ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------- full-pel and sub-pel
def _pir_cap(start_col=2, ref_end=2):
    """The cap map dispatch_pframe derives for a band from start_col after
    a reference refreshed up to column ref_end: dx <= 11 in column 0 and
    dx <= -5 in column 1, no cap from the band on."""
    band, cap = tinter.pir_maps((start_col, MBW - 1, ref_end), MBW, MBH,
                                "cpu")
    return cap


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "esa"])
@pytest.mark.parametrize("capped", [False, True], ids=["free", "pir_cap"])
def test_fullpel_16x16_lane_matches_x264_tpu(fctx, seeded, capped):
    cap = _pir_cap() if capped else None
    if capped:
        _eq(np.array([11, -5, 1 << 20]), cap[0])
    ref_j, ref_t = fctx["refs"][0]
    mvs_j, mvp_j = jinter.p_fullpel_core(
        jnp.asarray(fctx["y"]), ref_j["y_pad"], LAM,
        None if cap is None else jnp.asarray(cap.numpy()),
        me_range=ME_RANGE, shapes=False, me_seeded=seeded)
    mvs_t, mvp_t = tinter.p_fullpel_core(
        _t(fctx["y"]), ref_t["y_pad"], LAM, cap, me_range=ME_RANGE,
        me_seeded=seeded, shapes=False)
    assert set(mvs_t) == set(mvs_j) == {"16x16"}
    _eq(mvs_j["16x16"], mvs_t["16x16"], "mv")
    _eq(mvp_j, mvp_t, "mvp")


@pytest.mark.parametrize("wo", [(128, 0), (100, 7)], ids=["unit", "weighted"])
def test_p_subpel_core_without_partitions_matches_x264_tpu(fctx, wo):
    ref_j, ref_t = fctx["refs"][0]
    jy = jnp.asarray(fctx["y"])
    mvs_j, mvp_j = jinter.p_fullpel_core(jy, ref_j["y_pad"], LAM,
                                         me_range=ME_RANGE, shapes=False,
                                         me_seeded=True)
    ref = jinter.p_subpel_core(
        jy, ref_j["hpel"], mvs_j, mvp_j, LAM, jnp.asarray(wo[0]),
        jnp.asarray(wo[1]), me_range=ME_RANGE, partitions=False,
        p8x8=False, weighted=True, return_cands=False)
    got = tinter.p_subpel_core(
        _t(fctx["y"]), ref_t["hpel"], {"16x16": _t(mvs_j["16x16"])},
        _t(mvp_j), LAM, *wo, me_range=ME_RANGE, partitions=False)
    assert set(got) == set(ref)
    for key in ref:
        _eq(ref[key], got[key], key)


def test_p_rd_core_without_intra_matches_x264_tpu(fctx):
    ref_j, ref_t = fctx["refs"][0]
    jy = jnp.asarray(fctx["y"])
    mvs_j, mvp_j = jinter.p_fullpel_core(jy, ref_j["y_pad"], LAM,
                                         me_range=ME_RANGE, shapes=True,
                                         me_seeded=True)
    sp = jinter.p_subpel_core(
        jy, ref_j["hpel"], mvs_j, mvp_j, LAM, jnp.asarray(128),
        jnp.asarray(0), me_range=ME_RANGE, partitions=True, p8x8=True,
        weighted=True, return_cands=True)
    ref = jinter.p_rd_core(jy, sp["cand_pred"], sp["cand_mv"], mvp_j,
                           jnp.asarray(fctx["qp_mb"]), jnp.asarray(False),
                           None, mbw=MBW, mbh=MBH, p8x8=True,
                           two_refs=False, intra_rd=False)
    got = tinter.p_rd_core(_t(fctx["y"]), _t(sp["cand_pred"]),
                           _t(sp["cand_mv"]), _t(mvp_j), _t(fctx["qp_mb"]),
                           False, None, mbw=MBW, mbh=MBH, two_refs=False,
                           intra_rd=False)
    assert ref[3] is None and got[3] is None
    for i in range(3):
        _eq(ref[i], got[i], f"output {i}")


# ------------------------------------------------------- the P pipeline
# name -> flags; between them each of partitions, rd, intra_in_p, pir and
# nr is off in one and on in another
PIPELINES = {
    "ultrafast_pir_nr": dict(partitions=False, rd=False, intra_in_p=True,
                             i4=False, pir=True, nr=True, two_refs=False,
                             me_seeded=True, entropy=True, p8x8=False,
                             deblock=True),
    "no_intra_rd_two_refs": dict(partitions=True, rd=True, intra_in_p=False,
                                 i4=False, pir=False, nr=False,
                                 two_refs=True, me_seeded=True,
                                 entropy=True, p8x8=True, deblock=True),
    "no_partitions_no_intra_esa": dict(partitions=False, rd=True,
                                       intra_in_p=False, i4=False, pir=False,
                                       nr=False, two_refs=True,
                                       me_seeded=False, entropy=False,
                                       p8x8=False, deblock=False),
    "partitions_no_rd_nr_cabac": dict(partitions=True, rd=False,
                                      intra_in_p=True, i4=True, pir=False,
                                      nr=True, two_refs=False,
                                      me_seeded=True, entropy=False,
                                      p8x8=False, deblock=True),
}
NR_OFFSET = np.array([[0, 3, 2, 4], [3, 5, 4, 6], [2, 4, 3, 5],
                      [4, 6, 5, 7]], np.int32)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_encode_pframe_flags_match_x264_tpu(fctx, name):
    f = PIPELINES[name]
    refs = fctx["refs"][:2 if f["two_refs"] else 1]
    wp = (100, 7)
    cap_words = MBW * MBH * 128
    pir_band = pir_cap = None
    if f["pir"]:
        pir_band, pir_cap = tinter.pir_maps((1, 1, 2), MBW, MBH, "cpu")
    nr_offset = _t(NR_OFFSET) if f["nr"] else None
    jargs = [jnp.asarray(a) for a in (fctx["y"], fctx["u"], fctx["v"])]
    ref = jinter.encode_pframe_device(
        *jargs, refs[0][0]["y_pad"], refs[0][0]["hpel"],
        refs[0][0]["cuv_pad"], jnp.asarray(fctx["qp_mb"]),
        jnp.asarray(fctx["qpc_mb"]), QP, LAM,
        None if pir_cap is None else jnp.asarray(pir_cap.numpy()),
        None if pir_band is None else jnp.asarray(pir_band.numpy()),
        *((refs[1][0]["y_pad"], refs[1][0]["hpel"], refs[1][0]["cuv_pad"],
           jnp.asarray(True)) if f["two_refs"] else (None,) * 4),
        mbw=MBW, mbh=MBH, cap_words=cap_words, me_range=ME_RANGE,
        deblock=f["deblock"], decimate=True, entropy=f["entropy"],
        intra_in_p=f["intra_in_p"], partitions=f["partitions"],
        pir=f["pir"], me_seeded=f["me_seeded"], nr=f["nr"],
        nr_offset=None if nr_offset is None else jnp.asarray(NR_OFFSET),
        use_pallas=False, i4=f["i4"], wp_w=jnp.asarray(wp[0]),
        wp_o=jnp.asarray(wp[1]), two_refs=f["two_refs"], p8x8=f["p8x8"],
        rd=f["rd"])
    got = tinter.encode_pframe(
        _t(fctx["y"]), _t(fctx["u"]), _t(fctx["v"]), [r[1] for r in refs],
        _t(fctx["qp_mb"]), _t(fctx["qpc_mb"]), QP, LAM, wp, mbw=MBW,
        mbh=MBH, cap_words=cap_words, me_range=ME_RANGE,
        deblock=f["deblock"], a_off=0, b_off=0, cqpo=0, decimate=True,
        i4=f["i4"], two_refs=f["two_refs"], entropy=f["entropy"],
        p8x8=f["p8x8"], me_seeded=f["me_seeded"],
        partitions=f["partitions"], rd=f["rd"],
        intra_in_p=f["intra_in_p"], pir_cap=pir_cap, pir_band=pir_band,
        nr_offset=nr_offset)
    if f["entropy"]:
        bits = int(ref[1])
        assert int(got[1]) == bits
        nw = (bits + 31) // 32
        _eq(np.asarray(ref[0])[:nw], got[0][:nw], "words")
    else:
        assert got[1] is None and set(got[0]) == set(ref[0])
        for k in ref[0]:
            _eq(ref[0][k], got[0][k], k)
    for c in range(3):
        _eq(ref[2][c], got[2][c], f"recon plane {c}")
    rs, gs = ref[3], got[3]
    assert set(gs) == set(rs)
    for k in rs:
        if rs[k] is None:
            assert gs[k] is None, k
        else:
            _eq(rs[k], gs[k], k)
    if f["pir"]:
        assert int(gs["intra"]) >= MBH          # the band column is intra
    if not f["intra_in_p"]:
        assert int(gs["intra"]) == 0
    else:
        assert int(gs["intra"]) > 0
    if f["nr"]:
        assert gs["nr_sums"].shape == (4, 4)
    if not f["partitions"]:
        assert int(gs["p16x8"]) + int(gs["p8x16"]) + int(gs["p8x8"]) == 0


def test_encode_pframe_without_intra_makes_no_commit(fctx, monkeypatch):
    """intra_in_p False launches no commit (the mesh's band P step); with
    intra in P every frame commits once, intra MB or none."""
    calls = []
    real = tinter.commit

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tinter, "commit", counting)
    for intra_in_p, want in ((False, 0), (True, 1)):
        calls.clear()
        tinter.encode_pframe(
            _t(fctx["y"]), _t(fctx["u"]), _t(fctx["v"]),
            [fctx["refs"][0][1]], _t(fctx["qp_mb"]), _t(fctx["qpc_mb"]), QP,
            LAM, None, mbw=MBW, mbh=MBH, cap_words=MBW * MBH * 128,
            me_range=ME_RANGE, deblock=False, a_off=0, b_off=0, cqpo=0,
            decimate=True, i4=False, two_refs=False, p8x8=False,
            partitions=False, rd=False, intra_in_p=intra_in_p)
        assert len(calls) == want
