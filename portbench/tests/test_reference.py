"""The benchmark's reference decoder (portbench/reference) against the
port's CPU path at 64x48: each stream decodes to the encoder's
reconstruction; a decode started mid-stream from the encoder's
reconstructions (check.py's segments) gives the same; the vectorised
deblocking filter equals the scalar one."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, clipgen
from portbench.reference import decoder as D

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TYPES = {1: "I", 2: "I", 3: "P", 4: "B", 5: "B"}


def encode(opts, n=7, w=64, h=48):
    """(headers, coded) of n frames of the sports mix through the port's
    CPU path: coded as run.py records it."""
    from x264_tpu_torch.encoder.encoder import Encoder, Picture
    from x264_tpu_torch.params import param_default_preset, param_parse
    from portbench.run import full_planes
    p = param_default_preset("medium")
    for k, v in opts.items():
        param_parse(p, k, v)
    p.width, p.height = w, h
    with open(os.path.join(ROOT, "portbench", "traffic", "sports.json")) as f:
        clip = clipgen.make_clip(dict(json.load(f), frames=n), w, h, 9, "cpu")
    enc = Encoder(p, device="cpu")
    coded = []
    for i in range(n + 8):
        nals, out = enc.encode(Picture(clip[i], pts=i) if i < n else None)
        if out is not None:
            coded.append({"type": TYPES[out.i_type], "qp": out.qp,
                          "nals": [x.payload for x in nals],
                          "recon": full_planes(torch, out.recon,
                                               p.mb_width, p.mb_height)})
    return [x.payload for x in enc.headers()], coded


STREAMS = {
    "cavlc_ippp": {"cabac": "0", "bframes": "0", "crf": "23"},
    "cabac_ibbp": {"bframes": "2", "b-adapt": "0", "crf": "23",
                   "rc-lookahead": "4"},
}


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    torch.set_num_threads(1)
    return request.param, encode(STREAMS[request.param])


def test_whole_stream_decodes_to_the_reconstruction(stream):
    name, (headers, coded) = stream
    dec = D.Decoder()
    for n in headers:
        dec.decode_nal(n)
    for fr in coded:
        for n in fr["nals"]:
            dec.decode_nal(n)
    assert len(dec.full_frames) == len(coded)
    for fr, got in zip(coded, dec.full_frames):
        for a, b in zip(got, fr["recon"]):
            assert np.array_equal(a, b.numpy().astype(np.int64)), name
    assert dec.slice_qps == [fr["qp"] for fr in coded]
    if name == "cabac_ibbp":
        assert "B" in {fr["type"] for fr in coded}


def test_every_segment_decodes_to_the_reconstruction(stream):
    _, (headers, coded) = stream
    walk = check.headers_walk(headers, coded)
    for s in range(1, len(coded)):
        if coded[s]["type"] == "B":
            continue
        got, n_bad, err = check.decode_segment(headers, coded, walk, s,
                                               min(s + 3, len(coded)))
        assert n_bad == 0, err
        for i, planes, qp in got:
            assert qp == coded[i]["qp"]
            for a, b in zip(planes, coded[i]["recon"]):
                assert np.array_equal(a, b.numpy().astype(np.int64))


def test_compare_finds_a_changed_sample(stream):
    _, (headers, coded) = stream
    ok = check.compare(headers, coded, 1, len(coded),
                       list(range(len(coded))), 5, 2, 0)
    assert ok["correct"] and ok["decoded"]
    i = ok["decoded"][0]
    coded[i]["recon"][0][5, 7] ^= 1
    bad = check.compare(headers, coded, 1, len(coded),
                       list(range(len(coded))), 5, 2, 0)
    coded[i]["recon"][0][5, 7] ^= 1
    assert not bad["correct"]
    assert bad["numbers"]["mismatched_samples"]["value"] >= 1


def test_the_control_fails(stream):
    """The reference reconstructing one rounding coarser (the benchmark's
    control) no longer matches the encoder."""
    _, (headers, coded) = stream
    D.IDCT_ROUND = 0
    try:
        ctl = check.compare(headers, coded, 0, len(coded),
                            list(range(len(coded))), 5,
                            len(coded), 0)
    finally:
        D.IDCT_ROUND = 32
    assert not ctl["correct"]
    assert ctl["numbers"]["mismatched_samples"]["value"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_vectorised_deblock_equals_scalar(seed):
    rng = np.random.default_rng(seed)
    for trial in range(12):
        mbw, mbh = int(rng.integers(1, 7)), int(rng.integers(1, 6))
        H, W = mbh * 16, mbw * 16
        base = int(rng.integers(60, 200))
        y = np.clip(base + rng.integers(-12, 13, (H, W)), 0, 255)
        u = np.clip(base + rng.integers(-8, 9, (H // 2, W // 2)), 0, 255)
        v = np.clip(base + rng.integers(-8, 9, (H // 2, W // 2)), 0, 255)
        qp = rng.integers(10, 52, (mbh, mbw)).astype(np.int32)
        intra = rng.random((mbh, mbw)) < 0.3
        nnz = ((rng.random((mbh * 4, mbw * 4)) < 0.4)
               * rng.integers(1, 5, (mbh * 4, mbw * 4))).astype(np.int32)
        kind, b_info, ref4 = trial % 3, None, None
        if kind == 0:
            mvf = rng.integers(-6, 7, (mbh * 4, mbw * 4, 2))
            ref4 = rng.integers(0, 2, (mbh * 4, mbw * 4))
        elif kind == 1:
            mvf = rng.integers(-6, 7, (mbh, mbw, 2))
        else:
            mvf = None
            b_info = (rng.random((mbh, mbw)) < .7, rng.random((mbh, mbw)) < .5,
                      rng.integers(-6, 7, (mbh, mbw, 2)),
                      rng.integers(-6, 7, (mbh, mbw, 2)))
        offs = (int(rng.integers(-6, 7)), int(rng.integers(-6, 7))) \
            if trial % 2 else (0, 0)
        cqo = int(rng.integers(-3, 4))
        a = D.deblock_frame_scalar(y, u, v, qp, intra, nnz, mvf, *offs, cqo,
                                   b_info, ref4)
        b = D.deblock_frame_ref(y, u, v, qp, intra, nnz, mvf, *offs, cqo,
                                b_info, ref4)
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb), (seed, trial)
