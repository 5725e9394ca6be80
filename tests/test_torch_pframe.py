"""The port's IPPP encoder end to end against x264_tpu, at the settings
bench.py runs: preset medium, CQP 26, CAVLC, no B frames (2 references,
weightp, 16x8 / 8x16 / 8x8 partitions, subme 7, I_4x4 and intra in P,
dct decimation, deblock). The same frames and parameters through both
Encoders must give byte-identical streams, equal reconstructions and
equal MB statistics, and both decoders (tools/refdec.py, and libavcodec
through tools/avdec where it builds) must decode the port's stream to
the port's reconstruction.

Clips: "moving", 5 frames of test_inter_e2e.moving_frames at 64x48
(partitions, intra in P, weightp, both references from frame 2);
"fresh", the 96x64 clip of test_inter_e2e.test_intra_in_p_conformant
(new content that motion search cannot find, so MBs turn intra);
"static", three copies of one frame (skip runs)."""

import os
import subprocess
import sys

import numpy as np
import pytest
from test_inter_e2e import moving_frames
from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder.encoder import TYPE_IDR, TYPE_P
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu.encoder.encoder import Picture
from x264_tpu.entropy.nal import annexb_bytes
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.convert import dpb_entry_from_numpy, dpb_entry_to_numpy
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder.encoder import Encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402


def ippp_params(preset, w, h, scenecut=None):
    """bench.py's P-frame configuration: preset medium, no B frames, CQP
    26, CAVLC, the default keyint."""
    p = preset("medium")
    p.width, p.height = w, h
    p.cabac = False
    p.bframe = 0
    p.keyint_max = 250
    p.rc.rc_method = 0
    p.rc.qp_constant = 26
    p.full_recon = True
    if scenecut is not None:
        p.scenecut_threshold = scenecut
    return p


def fresh_frames():
    """test_intra_in_p_conformant's clip: frames 1 and 2 carry a block of
    new random content."""
    rng = np.random.default_rng(7)
    frames = moving_frames(3, 96, 64, seed=4)
    for i in (1, 2):
        frames[i][0][16:48, 32:80] = rng.integers(0, 256, (32, 48))
        frames[i][1][8:24, 16:40] = rng.integers(0, 256, (16, 24))
        frames[i][2][8:24, 16:40] = rng.integers(0, 256, (16, 24))
    return frames


def static_frames():
    f = moving_frames(1, 64, 48, seed=1)[0]
    return [f, f, f]


# name -> (frames, width, height, scenecut)
CLIPS = {
    "moving": (lambda: moving_frames(5, 64, 48), 64, 48, None),
    "fresh": (fresh_frames, 96, 64, 0),
    "static": (static_frames, 64, 48, None),
}


def encode_all(enc, frames):
    """Headers + every frame, drained -> (stream, recon planes, types)."""
    stream = annexb_bytes(enc.headers())
    recons, types = [], []
    for i, f in enumerate(frames + [None]):
        while True:
            nals, out = enc.encode(None if f is None else Picture(f, pts=i))
            stream += annexb_bytes(nals)
            if out is not None:
                recons.append([np.asarray(r) for r in out.recon])
                types.append(out.i_type)
            if f is not None or out is None:
                break
    return stream, recons, types


@pytest.fixture(scope="module", params=list(CLIPS))
def clip(request):
    make, w, h, scenecut = CLIPS[request.param]
    frames = make()
    jax_enc = JaxEncoder(ippp_params(jax_preset, w, h, scenecut))
    ref = encode_all(jax_enc, frames)
    enc = Encoder(ippp_params(param_default_preset, w, h, scenecut),
                  device="cpu")
    got = encode_all(enc, frames)
    return dict(name=request.param, w=w, h=h, n=len(frames), ref=ref,
                got=got, jax_enc=jax_enc, enc=enc)


def test_stream_bytes_match_x264_tpu(clip):
    assert clip["got"][2] == [TYPE_IDR] + [TYPE_P] * (clip["n"] - 1)
    assert clip["got"][2] == clip["ref"][2]
    assert clip["got"][0] == clip["ref"][0]


def test_reconstruction_matches_x264_tpu(clip):
    assert len(clip["got"][1]) == clip["n"]
    for i, (a, b) in enumerate(zip(clip["ref"][1], clip["got"][1])):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c],
                                          err_msg=f"frame {i} plane {c}")


def test_mb_stats_match_x264_tpu(clip):
    """The P-MB histogram and the weightp count; each clip drives the
    branch it was chosen for."""
    js, ts = clip["jax_enc"].stats, clip["enc"].stats
    assert ts["mb"]["P"] == js["mb"]["P"]
    assert ts.get("weightp_frames") == js.get("weightp_frames")
    mb = ts["mb"]["P"]
    if clip["name"] == "moving":
        assert mb["16x8"] + mb["8x16"] + mb["8x8"] > 0
        assert ts.get("weightp_frames", 0) > 0
    if clip["name"] == "fresh":
        assert 0 < mb["intra"] < mb["total"]
    if clip["name"] == "static":
        assert mb["skip"] > 0


def test_refdec_decodes_port_stream_to_its_recon(clip):
    dec = refdec.Decoder()
    decoded = dec.decode(clip["got"][0])
    assert len(decoded) == clip["n"]
    for i, (d, r) in enumerate(zip(decoded, clip["got"][1])):
        for c in range(3):
            np.testing.assert_array_equal(d[c], r[c],
                                          err_msg=f"frame {i} plane {c}")
    if clip["name"] == "fresh":
        assert dec.last_intra_map.any() and not dec.last_intra_map.all()


def test_avdec_decodes_port_stream_to_its_recon(clip, tmp_path):
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


def test_pframe_from_a_moved_dpb_matches_x264_tpu():
    """x264_tpu encodes an IDR and a P frame; its DPB (reference planes
    and the P frame's co-located mvf / mvf4 / inter_mask) moves into a
    port Encoder through convert. The next P frame, dispatched on both
    sides from that state with two live references, gives the same NAL
    bytes, reconstruction and co-located fields."""
    w, h = 64, 48
    frames = moving_frames(3, w, h, seed=5)
    jenc = JaxEncoder(ippp_params(jax_preset, w, h))
    encode_all(jenc, frames[:2])
    assert len(jenc._dpb) == 2 and "mvf4" in jenc._dpb[1]
    tenc = Encoder(ippp_params(param_default_preset, w, h), device="cpu")
    tenc._dpb = [dpb_entry_from_numpy(e, "cpu") for e in jenc._dpb]
    for je, te in zip(jenc._dpb, tenc._dpb):
        back = dpb_entry_to_numpy(te)
        assert set(back) == set(je)
        for k in ("y_pad", "hpel", "cuv_pad", "mvf", "mvf4", "inter_mask"):
            if k in je:
                np.testing.assert_array_equal(np.asarray(je[k]), back[k])
    for enc in (jenc, tenc):
        enc.frame_num, enc.poc = 2, 4
    tenc._last_ref_fn = jenc._last_ref_fn
    tenc._src_luma = dict(jenc._src_luma)
    tenc.idr_pic_id = jenc.idr_pic_id

    before = dict(jenc.stats["mb"]["P"])
    jfin, _, _, jtag = jinter.dispatch_pframe(jenc, frames[2], TYPE_P, 26)
    jfields = jenc._pending_ref_fields
    tfin, _, _, ttag = tinter.dispatch_pframe(tenc, tenc._pad_to_mb(
        frames[2]), TYPE_P, 26)
    tfields = tenc._pending_ref_fields
    assert ttag == jtag
    for k in ("mvf", "mvf4", "inter_mask"):
        np.testing.assert_array_equal(np.asarray(jfields[k]),
                                      tfields[k].numpy(), err_msg=k)
    jnals, jrec = jfin()
    tnals, trec = tfin()
    assert [n.payload for n in tnals] == [n.payload for n in jnals]
    for a, b in zip(jrec, trec):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tenc.stats["mb"]["P"] == {k: v - before[k] for k, v in
                                     jenc.stats["mb"]["P"].items()}



def test_pframe_overflow_reencode_matches_x264_tpu(monkeypatch):
    """A payload budget of 128 bytes per MB: noise frames at QP 12
    overflow it, so P frames take the re-encode at QP + 4 (retry), the
    DPB repair and the re-dispatch of the frame in flight; the port's
    stream and QPs stay those of x264_tpu and refdec decodes it."""
    from x264_tpu.encoder import intra as jintra
    from x264_tpu_torch.encoder import intra as tintra
    for mod in (jintra, jinter, tintra, tinter):
        monkeypatch.setattr(mod, "cap_bytes_per_mb", lambda qp: 128)
    rng = np.random.default_rng(11)
    frames = [[rng.integers(0, 256, s).astype(np.uint8)
               for s in ((64, 96), (32, 48), (32, 48))] for _ in range(3)]
    outs, encs = [], []
    for preset, make in ((jax_preset, JaxEncoder), (param_default_preset,
                                                    Encoder)):
        p = ippp_params(preset, 96, 64, scenecut=0)
        p.rc.qp_constant = 12
        enc = make(p) if make is JaxEncoder else make(p, device="cpu")
        assert enc._pipe_depth == 1
        outs.append(encode_all(enc, frames))
        encs.append(enc)
    (js, jrec, jtypes), (ts, trec, ttypes) = outs
    assert ttypes == jtypes == [TYPE_IDR, TYPE_P, TYPE_P]
    # both P frames were re-encoded above the requested QP 12
    assert encs[1].stats["qp_sum"] == encs[0].stats["qp_sum"]
    assert encs[1].stats["qp_sum"]["P"] >= 2 * 16
    assert ts == js
    for a, b in zip(jrec, trec):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    decoded = refdec.Decoder().decode(ts)
    for d, r in zip(decoded, trec):
        for c in range(3):
            np.testing.assert_array_equal(d[c], r[c])
