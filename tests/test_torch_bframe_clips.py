"""The port's B-frame path against x264_tpu, whole clips through both
Encoders: IBBP with spatial direct, CAVLC and CABAC, the flushed tail, the
exhaustive search on P frames, an overflow re-encode of a B frame (the
module twins are in test_torch_bframe.py). Every output is a byte stream
or a reconstruction: every comparison is exact (tolerance 0). Frames are
64x48."""

import numpy as np
import pytest
from test_inter_e2e import moving_frames
from torch_parity import bframe_params, encode_stream, refdec
from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder import bframe as jbframe
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu.encoder.encoder import TYPE_B, TYPE_IDR, TYPE_P
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder import bframe as tbframe
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.encoder.encoder import Encoder

I, P, B = TYPE_IDR, TYPE_P, TYPE_B
# name -> (params keywords, frames, expected frame types in coding order)
CLIPS = {
    "ibbp_cavlc": (dict(), 7, [I, P, B, B, P, B, B]),
    "ibbp_cabac": (dict(cabac=True), 7, [I, P, B, B, P, B, B]),
    # 6 frames at bframe 3: the window ends inside a B run, and the flush
    # codes what is left with its last frame as the anchor
    "flushed_tail": (dict(bframe=3), 6, [I, P, B, B, B, P]),
    # IPPP with the exhaustive search on P frames (me_method 3)
    "ippp_esa": (dict(bframe=0, me_method=3), 4, [I, P, P, P]),
}


@pytest.fixture(scope="module", params=list(CLIPS))
def clip(request):
    kw, n, types = CLIPS[request.param]
    frames = moving_frames(n, 64, 48)
    jenc = JaxEncoder(bframe_params(jax_preset, **kw))
    ref = encode_stream(jenc, frames)
    enc = Encoder(bframe_params(param_default_preset, **kw), device="cpu")
    got = encode_stream(enc, frames)
    return dict(name=request.param, n=n, types=types, ref=ref, got=got,
                jenc=jenc, enc=enc)


def test_stream_bytes_match_x264_tpu(clip):
    """NAL bytes, frame types, pts and dts of every output picture."""
    (jstream, jouts), (stream, outs) = clip["ref"], clip["got"]
    assert [o.i_type for o in outs] == clip["types"]
    for key in ("i_type", "pts", "dts", "qp", "b_keyframe"):
        assert [getattr(o, key) for o in outs] == \
            [getattr(o, key) for o in jouts], key
    assert sorted(o.pts for o in outs) == list(range(clip["n"]))
    if B in clip["types"]:
        # a B frame is coded after the anchor that follows it in display
        assert [o.pts for o in outs] != sorted(o.pts for o in outs)
        assert [o.dts for o in outs] == list(range(-1, clip["n"] - 1))
    assert stream == jstream


def test_reconstruction_matches_x264_tpu(clip):
    assert len(clip["got"][1]) == clip["n"]
    for a, b in zip(clip["ref"][1], clip["got"][1]):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a.recon[c]), np.asarray(b.recon[c]),
                err_msg=f"pts {a.pts} plane {c}")


def test_refdec_decodes_port_stream_to_its_recon(clip):
    """tools/refdec.py, which shares no code with either encoder, decodes
    the port's stream (coding order) to the port's reconstructions."""
    stream, outs = clip["got"]
    decoded = refdec.Decoder().decode(stream)
    assert len(decoded) == clip["n"]
    for d, o in zip(decoded, outs):
        for c in range(3):
            np.testing.assert_array_equal(d[c], np.asarray(o.recon[c]),
                                          err_msg=f"pts {o.pts} plane {c}")


def test_b_frames_take_every_mode_and_no_dpb_slot(clip):
    """The B-MB histogram of the clip: every mode occurs over the two IBBP
    clips' B frames, and a B frame leaves nothing in the DPB."""
    mb = clip["enc"].stats.get("mb", {}).get("B")
    nb = clip["types"].count(B)
    if nb == 0:
        assert mb is None
        return
    assert mb["total"] == nb * 12
    assert mb["l0"] + mb["l1"] + mb["bi"] + mb["direct"] == mb["total"]
    assert mb["skip"] <= mb["direct"]
    assert min(mb["l0"], mb["l1"], mb["bi"], mb["direct"]) > 0
    anchors = {o.pts for o in clip["got"][1] if o.i_type != B}
    assert {r["tag"] for r in clip["enc"]._dpb} <= anchors
    assert clip["enc"].stats["count"]["B"] == nb


def test_bframe_overflow_reencode_matches_x264_tpu(monkeypatch):
    """A payload budget of 128 bytes per MB: noise frames at QP 12
    overflow it, B frames included, so a B frame takes the re-encode at
    QP + 4 (its retry returns no reconstruction: nothing to repair in the
    DPB) and, when an anchor is re-encoded, the B frame in flight is
    dispatched again against the repaired references by its two tags."""
    for mod in (jintra, jinter, jbframe, tintra, tinter, tbframe):
        monkeypatch.setattr(mod, "cap_bytes_per_mb", lambda qp: 128)
    rng = np.random.default_rng(11)
    frames = [[rng.integers(0, 256, s).astype(np.uint8)
               for s in ((48, 64), (24, 32), (24, 32))] for _ in range(4)]
    runs = []
    for preset, make in ((jax_preset, JaxEncoder), (param_default_preset,
                                                    Encoder)):
        p = bframe_params(preset, qp=12, scenecut=0)
        enc = make(p) if make is JaxEncoder else make(p, device="cpu")
        assert enc._pipe_depth == 1
        runs.append((enc, *encode_stream(enc, frames)))
    (jenc, jstream, jouts), (enc, stream, outs) = runs
    assert [o.i_type for o in outs] == [I, P, B, B]
    assert [o.qp for o in outs] == [o.qp for o in jouts]
    nominal_b = Encoder(bframe_params(param_default_preset, qp=12),
                        device="cpu").rc.start(TYPE_B, -1, frame_idx=1)
    assert all(o.qp >= nominal_b + 4 for o in outs if o.i_type == B)
    assert stream == jstream
    for a, b in zip(jouts, outs):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(a.recon[c]),
                                          np.asarray(b.recon[c]))
    decoded = refdec.Decoder().decode(stream)
    for d, o in zip(decoded, outs):
        for c in range(3):
            np.testing.assert_array_equal(d[c], np.asarray(o.recon[c]))
