"""The port's B-frame path against x264_tpu: every module of it against
its JAX twin on the same seeded inputs (whole clips through both Encoders
are in test_torch_bframe_clips.py).

Every output is an integer or a byte stream: every comparison is exact
(tolerance 0). Frames are 64x48 (48x32 for the second search clip)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inter_e2e import moving_frames
from test_torch_inter import _eq, _ref_entry, _t
from x264_tpu.encoder import bdirect as jbdirect
from x264_tpu.encoder import bframe as jbframe
from x264_tpu.encoder import inter as jinter
from x264_tpu.entropy import cavlc_jax
from x264_tpu.ops import deblock as jdeblock
from x264_tpu.ops import trellis as jtrellis
from x264_tpu.ops.tables import chroma_qp
from x264_tpu_torch.encoder import bdirect as tbdirect
from x264_tpu_torch.encoder import bframe as tbframe
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.entropy import cavlc_dev
from x264_tpu_torch.ops import deblock as tdeblock
from x264_tpu_torch.ops import trellis as ttrellis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402

QP = 26
LAM = 6          # max(1, round(2 ** ((26 - 12) / 6)))
ME_RANGE = 16


# ----------------------------------------------------------- module twins
@pytest.mark.parametrize("seed", [0, 1])
def test_satd16_matches_x264_tpu(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 256, (7, 16, 16)).astype(np.int32)
    src = rng.integers(0, 256, (7, 16, 16)).astype(np.uint8)
    _eq(jinter._satd16(jnp.asarray(pred), jnp.asarray(src)),
        tinter._satd16(_t(pred), _t(src)))


def _search_clip(kind, seed):
    """(current luma, reference frame) of a clip with real motion, or of a
    flat one where every offset ties."""
    if kind == "moving":
        frames = moving_frames(2, 64, 48, seed=seed)
        return frames[1][0], frames[0]
    flat = [np.full(s, 90 + seed, np.uint8)
            for s in ((32, 48), (16, 24), (16, 24))]
    return flat[0].copy(), flat


_jax_esa = jax.jit(jinter.motion_search, static_argnums=(4, 5))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["moving", "flat"])
@pytest.mark.parametrize("shapes", [False, True], ids=["mv16", "shapes"])
def test_motion_search_matches_x264_tpu(shapes, kind, seed):
    """The exhaustive search, one row of offsets per step in the port and
    one offset per step in x264_tpu: the same winners, ties included (a
    flat clip ties every offset of a row and every row)."""
    y, ref = _search_clip(kind, seed)
    jref, tref = _ref_entry(ref)
    want = _jax_esa(jref["y_pad"], None, jnp.asarray(y), LAM, ME_RANGE,
                    shapes)
    got = tinter.motion_search(tref["y_pad"], None, _t(y), LAM, ME_RANGE,
                               shapes=shapes)
    if not shapes:
        want, got = {"16x16": want}, {"16x16": got}
    assert set(got) == set(want)
    for key in want:
        _eq(want[key], got[key], key)
    if kind == "moving":
        assert np.asarray(want["16x16"]).any()


@pytest.fixture(scope="module")
def bctx():
    """Frame 1 of the moving clip between references frame 0 (list 0) and
    frame 2 (list 1), with the JAX search results."""
    w, h = 64, 48
    frames = moving_frames(3, w, h, seed=3)
    y, u, v = frames[1]
    mbw, mbh = w // 16, h // 16
    r0, r1 = _ref_entry(frames[0]), _ref_entry(frames[2])
    qp_mb = np.full((mbh, mbw), QP, np.int32)
    qp_mb[1, 2] = QP + 3                     # a mb_qp_delta on the way
    qpc_mb = np.asarray(chroma_qp(qp_mb, 0), np.int32)
    c = dict(w=w, h=h, mbw=mbw, mbh=mbh, n=mbw * mbh, y=y, u=u, v=v, r0=r0,
             r1=r1, qp_mb=qp_mb, qpc_mb=qpc_mb)
    c["mv_c"] = [np.asarray(_jax_esa(r[0]["y_pad"], None, jnp.asarray(y),
                                     LAM, ME_RANGE, False))
                 for r in (r0, r1)]
    # a co-located P anchor: some MBs intra, small MVs, partitions in mvf4
    rng = np.random.default_rng(9)
    c["col_inter"] = rng.random((mbh, mbw)) < 0.7
    c["col_mv"] = rng.integers(-2, 3, (mbh, mbw, 2)).astype(np.int32)
    c["col_uniform"] = rng.random((mbh, mbw)) < 0.8
    return c


@pytest.mark.parametrize("lst", [0, 1])
def test_subpel_refine_mc_matches_x264_tpu(bctx, lst):
    c = bctx
    ref = (c["r0"], c["r1"])[lst]
    want = jinter.subpel_refine_mc(ref[0]["hpel"], jnp.asarray(c["y"]),
                                   jnp.asarray(c["mv_c"][lst]), LAM, ME_RANGE)
    got = tinter.subpel_refine_mc(ref[1]["hpel"], _t(c["y"]),
                                  _t(c["mv_c"][lst]), LAM, ME_RANGE)
    for name, a, b in zip(("mvq", "pred", "cost"), want, got):
        _eq(a, b, name)


def _direct_fields(rng, mbh, mbw):
    use0 = rng.random((mbh, mbw)) < 0.7
    use1 = rng.random((mbh, mbw)) < 0.7
    mv0 = np.where(use0[..., None], rng.integers(-40, 40, (mbh, mbw, 2)), 0)
    mv1 = np.where(use1[..., None], rng.integers(-40, 40, (mbh, mbw, 2)), 0)
    col_i = rng.random((mbh, mbw)) < 0.6
    col_m = rng.integers(-3, 3, (mbh, mbw, 2))
    return (use0, use1, mv0.astype(np.int32), mv1.astype(np.int32), col_i,
            col_m.astype(np.int32))


@pytest.mark.parametrize("trial", range(4))
def test_derive_direct_matches_x264_tpu_and_the_decoder(trial):
    """derive_direct against its JAX twin, and against the scalar
    derivation of the reference decoder (tools/refdec.py), MB by MB."""
    rng = np.random.default_rng(3 + trial)
    mbh, mbw = 5, 7
    f = _direct_fields(rng, mbh, mbw)
    want = jbdirect.derive_direct(*[jnp.asarray(a) for a in f])
    got = tbdirect.derive_direct(*[_t(a) for a in f])
    for name, a, b in zip(("use0", "use1", "mv0", "mv1"), want, got):
        _eq(a, b, name)
    du0, du1, dm0, dm1 = [g.numpy() for g in got]
    use0, use1, mv0, mv1, col_i, col_m = f
    dec = refdec.Decoder()
    for my in range(mbh):
        for mx in range(mbw):
            su0, su1, sm0, sm1 = dec._derive_direct_mb(
                mv0.astype(np.int64), use0, mv1.astype(np.int64), use1, mx,
                my, col_i, col_m.astype(np.int64))
            assert (bool(du0[my, mx]), bool(du1[my, mx])) == (su0, su1)
            if su0:
                assert np.array_equal(dm0[my, mx], sm0), (my, mx)
            if su1:
                assert np.array_equal(dm1[my, mx], sm1), (my, mx)


@pytest.mark.parametrize("lst", [0, 1])
def test_direct_pred_luma_matches_x264_tpu(bctx, lst):
    """Luma MC at a per-MB quarter-pel MV, negative MVs and all 16
    phases present."""
    c = bctx
    ref = (c["r0"], c["r1"])[lst]
    rng = np.random.default_rng(20 + lst)
    base = rng.integers(-(ME_RANGE - 2), ME_RANGE - 1, (c["n"], 2)) * 4
    phases = set()
    for start in (0, 4):                 # 12 MBs: two fields hold all 16
        q = (np.arange(c["n"]) + start) % 16
        dmv = (base + np.stack([q & 3, q >> 2], axis=1)).astype(np.int32)
        phases |= set(((dmv[:, 1] & 3) * 4 + (dmv[:, 0] & 3)).tolist())
        assert (dmv < 0).any()
        want = jbdirect.direct_pred_luma(ref[0]["hpel"], jnp.asarray(dmv),
                                         c["mbh"], c["mbw"], ME_RANGE)
        got = tbdirect.direct_pred_luma(ref[1]["hpel"], _t(dmv), c["mbh"],
                                        c["mbw"], ME_RANGE)
        _eq(want, got)
    assert phases == set(range(16))


def _implicit_weights_python(poc_cur, poc_l0, poc_l1):
    """x264_tpu bframe.implicit_weights, which is pure Python."""
    tb = max(-128, min(127, poc_cur - poc_l0))
    td = max(-128, min(127, poc_l1 - poc_l0))
    if td == 0:
        return 32, 32
    tx = (16384 + abs(td >> 1)) // td
    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def test_implicit_weights_match_x264_tpu():
    """Every (tb, td) of a small range, negative distances included (the
    floor of a negative quotient), and the clamps at +-128."""
    seen = set()
    pairs = [(tb, td) for tb in range(-12, 13) for td in range(-12, 13)]
    pairs += [(200, 300), (-200, -300), (1, 127), (127, 1), (-128, 3)]
    for tb, td in pairs:
        got = tbframe.implicit_weights(tb, 0, td)
        assert got == jbframe.implicit_weights(tb, 0, td), (tb, td)
        assert got == _implicit_weights_python(tb, 0, td), (tb, td)
        seen.add(got)
    assert (32, 32) in seen and len(seen) > 20


@pytest.mark.parametrize("seed", [0, 1])
def test_mv_predictors_b_matches_x264_tpu(seed):
    rng = np.random.default_rng(seed)
    mbh, mbw = 5, 6
    mv = rng.integers(-60, 60, (mbh, mbw, 2)).astype(np.int32)
    use = rng.random((mbh, mbw)) < (0.5 + 0.3 * seed)
    _eq(jbframe.mv_predictors_b(jnp.asarray(mv), jnp.asarray(use)),
        tbframe.mv_predictors_b(_t(mv), _t(use)))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_strengths_b_matches_x264_tpu(seed):
    rng = np.random.default_rng(seed)
    mbh, mbw = 4, 5
    nnz4 = (rng.integers(0, 3, (mbh * 4, mbw * 4))
            * (rng.random((mbh * 4, mbw * 4)) < 0.3)).astype(np.int32)
    use0 = rng.random((mbh, mbw)) < 0.6
    use1 = ~use0 | (rng.random((mbh, mbw)) < 0.4)
    mv0 = rng.integers(-6, 7, (mbh, mbw, 2)).astype(np.int32)
    mv1 = rng.integers(-6, 7, (mbh, mbw, 2)).astype(np.int32)
    args = (nnz4, use0, use1, mv0, mv1)
    want = jdeblock.compute_strengths_b(*[jnp.asarray(a) for a in args],
                                        mbw=mbw, mbh=mbh)
    got = tdeblock.compute_strengths_b(*[_t(a) for a in args], mbw=mbw,
                                       mbh=mbh)
    for a, b in zip(want, got):
        _eq(a, b)
    assert set(np.unique(got[0].numpy())) == {0, 1, 2}


def _entropy_inputs(case):
    """Seeded B-slice decisions on a 4x3 MB frame: every mode, and per
    case a leading skip run, a trailing one, or a level past the escape
    range."""
    rng = np.random.default_rng(31)
    mbw, mbh = 4, 3
    n = mbw * mbh
    mode = np.array([3, 3, 0, 1, 2, 3, 0, 2, 1, 3, 3, 3], np.int32)
    if case == "coded_ends":
        mode[0], mode[-1] = 0, 2
    mvd0 = rng.integers(-70, 70, (n, 2)).astype(np.int32)
    mvd1 = rng.integers(-70, 70, (n, 2)).astype(np.int32)
    luma = (rng.integers(-3, 4, (n, 16, 4, 4))
            * (rng.random((n, 16, 4, 4)) < 0.15)).astype(np.int32)
    cdc = (rng.integers(-2, 3, (n, 2, 2, 2))
           * (rng.random((n, 2, 2, 2)) < 0.4)).astype(np.int32)
    cac = (rng.integers(-2, 3, (n, 2, 4, 4, 4))
           * (rng.random((n, 2, 4, 4, 4)) < 0.1)).astype(np.int32)
    cac[:, :, :, 0, 0] = 0
    # direct MBs 0, 1 (leading) and 9..11 (trailing) carry no residual:
    # they are the B_Skip runs
    skip = np.zeros(n, bool)
    if case != "coded_ends":
        for k in (0, 1, 9, 10, 11):
            luma[k] = 0
            cdc[k] = 0
            cac[k] = 0
            skip[k] = True
    if case == "overflow":
        luma[4, 3, 0, 0] = 9000
    nnz = (luma.reshape(n, 16, 16) != 0).sum(2)
    quad = [(b // 4 // 2) * 2 + (b % 4) // 2 for b in range(16)]
    cbp_luma = np.zeros(n, np.int32)
    for b in range(16):
        cbp_luma |= (nnz[:, b] > 0).astype(np.int32) << quad[b]
    cbp_chroma = np.where((cac != 0).any(axis=(1, 2, 3, 4)), 2, np.where(
        (cdc != 0).any(axis=(1, 2, 3)), 1, 0)).astype(np.int32)
    qp = rng.integers(22, 31, n).astype(np.int32)
    return dict(args=(mode, mvd0, mvd1, cbp_luma, cbp_chroma, qp),
                blocks=(luma, cdc, cac), skip=skip, mbw=mbw, mbh=mbh, n=n)


@pytest.mark.parametrize("case", ["skip_runs", "coded_ends", "overflow"])
def test_encode_bframe_entropy_dev_matches_x264_tpu(case):
    """The B-slice CAVLC writer: the packed words (n + 1 group rows), the
    bit count and the decoder-carried QP."""
    d = _entropy_inputs(case)
    cap_words = d["n"] * 450 // 4
    kw = dict(mbw=d["mbw"], mbh=d["mbh"], cap_words=cap_words)
    jw, jbits, jeff = cavlc_jax.encode_bframe_entropy_dev(
        *[jnp.asarray(a) for a in d["args"]], QP,
        *[jnp.asarray(a) for a in d["blocks"]], skip=jnp.asarray(d["skip"]),
        **kw)
    tw, tbits, teff = cavlc_dev.encode_bframe_entropy_dev(
        *[_t(a) for a in d["args"]], QP, *[_t(a) for a in d["blocks"]],
        skip=_t(d["skip"]), **kw)
    assert int(tbits) == int(jbits)
    _eq(np.asarray(jw).astype(np.int64), tw)
    _eq(jeff, teff)
    if case == "overflow":
        assert int(tbits) == cap_words * 32
    else:
        assert 0 < int(tbits) < cap_words * 32 - 32
        assert set(d["args"][0].tolist()) == {0, 1, 2, 3}


B_DEVICE_CASES = {
    "cavlc_direct": dict(entropy=True, use_direct=True, trellis=False),
    "cavlc_no_direct": dict(entropy=True, use_direct=False, trellis=False),
    "decisions_trellis": dict(entropy=False, use_direct=True, trellis=True),
}


@pytest.mark.parametrize("case", list(B_DEVICE_CASES))
def test_encode_bframe_device_matches_x264_tpu(bctx, case):
    """The whole B pass: words or decisions, the reconstruction after the
    deblock, and the statistics."""
    c, opts = bctx, B_DEVICE_CASES[case]
    w0, w1 = 21, 43                      # uneven implicit weights
    cap_words = c["n"] * 450 // 4
    kw = dict(mbw=c["mbw"], mbh=c["mbh"], cap_words=cap_words,
              me_range=ME_RANGE, deblock=True, a_off=0, b_off=0, cqpo=0,
              decimate=True, **opts)
    jtabs = ttabs = None
    if opts["trellis"]:
        jtabs = tuple(jnp.asarray(t) for t in
                      jtrellis.frame_ctx_costs(False, QP, cat=2))
        ttabs = ttrellis.frame_ctx_costs(False, QP, cat=2)
    planes = (c["y"], c["u"], c["v"])
    maps = (c["qp_mb"], c["qpc_mb"])
    col = (c["col_inter"], c["col_mv"], c["col_uniform"])

    def refs(k):
        return [r[k][name] for r in (c["r0"], c["r1"])
                for name in ("y_pad", "hpel", "cuv_pad")]

    jwords, jbits, jrec, jstats = jbframe.encode_bframe_device(
        *[jnp.asarray(p) for p in planes], *refs(0),
        *[jnp.asarray(m) for m in maps], QP, LAM, jnp.asarray(w0, jnp.int32),
        jnp.asarray(w1, jnp.int32), *[jnp.asarray(a) for a in col],
        trl_tabs=jtabs, **kw)
    twords, tbits, trec, tstats = tbframe.encode_bframe_device(
        *[_t(p) for p in planes], *refs(1), *[_t(m) for m in maps], QP, LAM,
        w0, w1, *[_t(a) for a in col], trl_tabs=ttabs, **kw)
    for a, b in zip(jrec, trec):
        _eq(a, b, "recon")
    for key in ("satd", "skip", "direct"):
        assert int(tstats[key]) == int(jstats[key]), key
    assert (int(tstats["direct"]) > 0) == opts["use_direct"]
    assert sum(int(tstats[k]) for k in ("l0", "l1", "bi", "direct")) == c["n"]
    if opts["entropy"]:
        assert int(tbits) == int(jbits)
        _eq(np.asarray(jwords).astype(np.int64), twords)
    else:
        assert tbits is None and jbits is None
        assert set(twords) == set(jwords)
        for key in jwords:
            _eq(np.asarray(jwords[key]).astype(np.int64),
                twords[key].to(torch.int64), key)
