"""The port's lookahead for B frames and MB-tree against x264_tpu, and the
encode a user gets from the default parameters (CRF 23, CABAC, bframe 3
with the fast adaptive B-run decision, MB-tree, AQ) through both Encoders.

Integer outputs and streams are compared exactly. MB-tree's offsets are
float32: the port sums the propagation in x264_tpu's order (equal bit for
bit here) and takes log2 through float64, where XLA's float32 log2 may be
an ulp off. An offset is strength (2.0 at the default qcompress) times the
difference of two such logs, each below 16 (one ulp: 9.54e-7), so the
offsets agree within 4e-6, and the QP maps rounded from them must be
equal."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inter_e2e import moving_frames
from test_torch_inter import _eq, _t
from torch_parity import encode_stream
from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder import frame_encode as jframe_encode
from x264_tpu.encoder import lookahead as jlook
from x264_tpu.encoder.encoder import TYPE_B, TYPE_IDR, TYPE_P
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu.encoder.encoder import Picture
from x264_tpu_torch import param_default_preset
from x264_tpu_torch import params as tparams
from x264_tpu_torch.encoder import frame_encode as tframe_encode
from x264_tpu_torch.encoder import lookahead as tlook
from x264_tpu_torch.encoder.encoder import Encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402

TOL = 4e-6       # on MB-tree offsets; the QP maps from them must be equal


def _lowres(seed, n, w=64, h=48):
    """Lowres planes of n frames of the moving clip, as numpy."""
    return [np.asarray(jlook.lowres_plane(jnp.asarray(f[0]))[0])
            for f in moving_frames(n, w, h, seed=seed)]


@pytest.mark.parametrize("seed", [0, 4])
def test_bidir_cost_matches_x264_tpu(seed):
    low = _lowres(seed, 3, 96, 64)
    rng = np.random.default_rng(seed)
    bh, bw = low[0].shape[0] // 8, low[0].shape[1] // 8
    mv0 = rng.integers(-8, 9, (bh, bw, 2)).astype(np.int32)
    mv1 = rng.integers(-8, 9, (bh, bw, 2)).astype(np.int32)
    want = jlook._bidir_cost(jnp.asarray(low[1]), jnp.asarray(low[0]),
                             jnp.asarray(low[2]), jnp.asarray(mv0),
                             jnp.asarray(mv1))
    _eq(want, tlook._bidir_cost(_t(low[1]), _t(low[0]), _t(low[2]), _t(mv0),
                                _t(mv1)))


def _tree_fields(seed, bh=6, bw=8):
    rng = np.random.default_rng(seed)
    intra = rng.integers(40, 4000, (bh, bw)).astype(np.int32)
    cost = (intra * rng.random((bh, bw)) * 1.2).astype(np.int32)
    prop = (rng.random((bh, bw)) * 3000).astype(np.float32)
    # MVs that pile many sources onto few targets, and push some outside
    mv = rng.integers(-8, 9, (bh, bw, 2)).astype(np.int32)
    mv[:, :2] = (-8, -8)
    return intra, cost, prop, mv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mbtree_propagate_matches_x264_tpu(seed):
    """The four float32 scatter-adds with duplicate targets: the port adds
    in x264_tpu's order, so the sums are equal to the last bit."""
    intra, cost, prop, mv = _tree_fields(seed)
    want = np.asarray(jlook._mbtree_propagate(
        jnp.asarray(intra), jnp.asarray(cost), jnp.asarray(prop),
        jnp.asarray(mv)))
    got = tlook._mbtree_propagate(_t(intra), _t(cost), _t(prop), _t(mv))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    assert want.max() > 0


def test_ordered_scatter_add_is_sequential():
    """Sources onto one target are added in their order, in float32: the
    values are chosen so that another order gives another sum."""
    idx = np.array([2, 0, 2, 2, 1, 2, 0], np.int64)
    val = np.array([1e8, 1.0, 1.0, -1e8, 3.0, 1.0, 2.5], np.float32)
    want = np.zeros(4, np.float32)
    for k, v in zip(idx, val):
        want[k] = np.float32(want[k] + v)
    got = tlook._ordered_scatter_add(4, _t(idx), _t(val)).numpy()
    np.testing.assert_array_equal(want, got)
    # target 2 in order: 1e8 + 1 = 1e8 in float32, - 1e8 = 0, + 1 = 1
    assert want[2] == 1.0 and np.float32(1e8 - 1e8 + 1.0 + 1.0) == 2.0


@pytest.mark.parametrize("seed", [0, 1])
def test_mbtree_finish_matches_x264_tpu(seed):
    intra, _, prop, _ = _tree_fields(seed)
    strength = 5.0 * (1.0 - 0.6)
    want = np.asarray(jlook._mbtree_finish(jnp.asarray(intra),
                                           jnp.asarray(prop), strength))
    got = tlook._mbtree_finish(_t(intra), _t(prop), strength).numpy()
    assert got.dtype == np.float32
    assert np.abs(want - got).max() <= TOL
    assert (got < 0).all()


class _Enc:
    """What build_qp_maps reads of an encoder."""

    def __init__(self, p, mbw, mbh):
        self.p, self.mb_w, self.mb_h = p, mbw, mbh


@pytest.fixture(scope="module")
def windows():
    """A 10-frame window pushed into both Lookaheads."""
    frames = moving_frames(10, 64, 48, seed=6)
    out = []
    for preset, mod in ((jax_preset, jlook), (param_default_preset, tlook)):
        p = preset("medium")
        p.width, p.height = 64, 48
        look = mod.Lookahead(p)
        for i, f in enumerate(frames):
            planes = f if mod is jlook else [_t(a) for a in f]
            look.push(planes, Picture(f, pts=i), i)
        out.append((p, look))
    return frames, out


@pytest.mark.parametrize("anchor_pos", [0, 3, 8])
def test_mbtree_offsets_match_x264_tpu(windows, anchor_pos):
    """Lookahead._mbtree_offsets over the window, and the QP maps that
    build_qp_maps rounds from AQ plus these offsets."""
    frames, ((jp, jl), (tp, tl)) = windows
    assert jl.mbtree and tl.mbtree and tl.depth == jl.depth == 24
    assert tl.tree_strength == jl.tree_strength
    want = jl._mbtree_offsets(anchor_pos)
    got = tl._mbtree_offsets(anchor_pos)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 4)
    assert np.abs(want - got).max() <= TOL
    assert abs(float(got.mean())) < 1e-5 and np.abs(got).max() > 0.05
    y, u, v = frames[anchor_pos]
    for qp in (20, 23, 31):
        jq = jframe_encode.build_qp_maps(
            _Enc(jp, 4, 3), jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            qp, want)
        tq = tframe_encode.build_qp_maps(_Enc(tp, 4, 3), _t(y), _t(u),
                                         _t(v), qp, got)
        for a, b in zip(jq, tq):
            _eq(a, b)


def test_mbtree_offsets_none_after_the_last_frame(windows):
    _, ((_, jl), (_, tl)) = windows
    assert tl._mbtree_offsets(9) is None and jl._mbtree_offsets(9) is None


# ----------------------------------------------------- the default encode
def default_params(preset):
    """param_default_preset("medium") with only the size and `threads`
    set: CRF 23, CABAC, bframe 3, B_ADAPT_FAST, MB-tree, AQ."""
    p = preset("medium")
    p.width, p.height = 64, 48
    p.threads = 1
    return p


N_DEFAULT = 28       # more than the MB-tree window's 24 frames


@pytest.fixture(scope="module")
def default_clip():
    """The clip through both Encoders, with the MB-tree offsets stamped at
    every decision and the pts whose encode call gave the first picture."""
    frames = moving_frames(N_DEFAULT, 64, 48, seed=3)
    runs = []
    for preset, make in ((jax_preset, JaxEncoder), (param_default_preset,
                                                    Encoder)):
        p = default_params(preset)
        p.full_recon = True
        enc = make(p) if make is JaxEncoder else make(p, device="cpu")
        tree, first_out = [], []
        decide = enc._lookahead.decide

        def spy(*a, _decide=decide, _tree=tree, **kw):
            out = _decide(*a, **kw)
            _tree.extend(e.get("tree_off") for e, *_ in out or [])
            return out

        enc._lookahead.decide = spy
        encode = enc.encode

        def counting(pic, _encode=encode, _first=first_out):
            nals, out = _encode(pic)
            if out is not None and not _first:
                _first.append(pic.pts if pic is not None else None)
            return nals, out

        enc.encode = counting
        stream, outs = encode_stream(enc, frames)
        runs.append(dict(enc=enc, tree=tree, stream=stream, outs=outs,
                         first_out=first_out[0]))
    return runs


def test_default_params_validate_unchanged():
    """The configuration under test is the default one."""
    p = Encoder(default_params(param_default_preset), device="cpu").p
    assert p.rc.rc_method == tparams.RC_CRF and p.rc.rf_constant == 23.0
    assert p.cabac and p.bframe == 3 and p.rc.mb_tree and p.rc.aq_mode
    assert p.bframe_adaptive == tparams.B_ADAPT_FAST
    assert p.analyse.direct_mv_pred != 0 and p.analyse.trellis == 1


def test_default_stream_matches_x264_tpu(default_clip):
    jr, tr = default_clip
    for key in ("i_type", "pts", "dts", "qp", "b_keyframe"):
        assert [getattr(o, key) for o in tr["outs"]] == \
            [getattr(o, key) for o in jr["outs"]], key
    types = [o.i_type for o in tr["outs"]]
    assert types[0] == TYPE_IDR and TYPE_B in types and TYPE_P in types
    assert sorted(o.pts for o in tr["outs"]) == list(range(N_DEFAULT))
    assert len({o.qp for o in tr["outs"]}) > 2          # CRF moves the QP
    assert tr["stream"] == jr["stream"]


def test_default_window_fills_before_the_flush(default_clip):
    """With MB-tree the window is 24 frames deep: the first picture comes
    out while frames are still going in, not at the flush."""
    jr, tr = default_clip
    assert tr["enc"]._lookahead.depth == 24
    assert tr["first_out"] == jr["first_out"]
    assert tr["first_out"] is not None and tr["first_out"] < N_DEFAULT


def test_default_mbtree_offsets_match_x264_tpu(default_clip):
    """The offsets stamped on every anchor while the clip was encoded."""
    jr, tr = default_clip
    assert len(tr["tree"]) == len(jr["tree"]) == N_DEFAULT
    stamped = 0
    for a, b in zip(jr["tree"], tr["tree"]):
        assert (a is None) == (b is None)
        if a is not None:
            stamped += 1
            assert np.abs(a - b).max() <= TOL
            assert np.abs(b).max() > 0
    anchors = sum(o.i_type != TYPE_B for o in tr["outs"])
    assert 0 < stamped <= anchors


def test_default_reconstruction_matches_x264_tpu(default_clip):
    jr, tr = default_clip
    for a, b in zip(jr["outs"], tr["outs"]):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a.recon[c]), np.asarray(b.recon[c]),
                err_msg=f"pts {a.pts} plane {c}")


def test_refdec_decodes_default_stream_to_its_recon(default_clip):
    tr = default_clip[1]
    decoded = refdec.Decoder().decode(tr["stream"])
    assert len(decoded) == N_DEFAULT
    for d, o in zip(decoded, tr["outs"]):
        for c in range(3):
            np.testing.assert_array_equal(d[c], np.asarray(o.recon[c]),
                                          err_msg=f"pts {o.pts} plane {c}")


def _set(path, value):
    def apply(p):
        obj = p
        *head, last = path.split(".")
        for name in head:
            obj = getattr(obj, name)
        setattr(obj, last, value)
    return apply


# options that raised naming a ROADMAP item until they were ported; at
# the defaults each now encodes, except PCM, which x264_tpu keeps intra
# only (None: the message a P frame under it raises with, as x264_tpu's)
UNPORTED = {
    "pir": (_set("intra_refresh", True), None),
    "ssim": (_set("analyse.ssim", True), None),
    "pcm": (_set("force_pcm", True), "intra-only"),
    "noise_reduction": (_set("analyse.noise_reduction", 100), None),
    "no_partitions": (_set("analyse.inter", 0), None),
    "subme_6": (_set("analyse.subpel_refine", 6), None),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_still_name_their_roadmap_item(name):
    """Each option at the defaults (CRF, B frames, MB-tree) encodes on the
    port, and refdec decodes the stream to its reconstruction; force_pcm
    raises at the first P frame, as in x264_tpu. Their parity with
    x264_tpu is held in tests/test_torch_{presets_fast,presets_ref2,
    options,recovery}.py."""
    change, raises = UNPORTED[name]
    p = default_params(param_default_preset)
    change(p)
    p.full_recon = True
    frames = moving_frames(3, 64, 48)
    if raises:
        with pytest.raises(NotImplementedError, match=raises):
            encode_stream(Encoder(p, device="cpu"), frames)
        return
    stream, outs = encode_stream(Encoder(p, device="cpu"), frames)
    assert len(outs) == 3
    if name == "pir":           # no B frames and no IDR after the first
        assert [o.i_type for o in outs][1:] == [TYPE_P] * 2
    if name == "ssim":
        assert all(0.5 < o.ssim <= 1.0 for o in outs)
    decoded = refdec.Decoder().decode(stream)
    assert len(decoded) == 3
    for d, o in zip(decoded, outs):
        for c in range(3):
            np.testing.assert_array_equal(d[c], np.asarray(o.recon[c]))


@pytest.mark.parametrize("me_method", [3, 4], ids=["esa", "tesa"])
def test_default_encode_with_exhaustive_search_runs(me_method):
    """me_method esa / tesa no longer raises; the B frames of the default
    encode ran the exhaustive search all along."""
    p = default_params(param_default_preset)
    p.analyse.me_method = me_method
    stream, outs = encode_stream(Encoder(p, device="cpu"),
                              moving_frames(5, 64, 48))
    assert len(outs) == 5 and len(stream) > 100
