"""Options around the P path through both Encoders at 64x48 (preset
medium, IPPP, CQP 26, CAVLC unless a case says otherwise), each held
against x264_tpu byte for byte, in reconstruction and in the P-MB
histogram, with tools/refdec.py decoding the port's stream to its
reconstruction:

- noise reduction (--nr 200), CAVLC and CABAC: the offsets learned in
  finalize (Encoder._nr_state) equal x264_tpu's too;
- SSIM on: each frame's SSIM within 1e-6 of x264_tpu's (both float32; a
  fused multiply-add in XLA is the difference), the stats' sums too;
- reconfig of deblocking_filter (off) and keyint_max (3) after frame 2;
- I_PCM frames (tests/test_pcm_e2e.py's configuration: ultrafast,
  force_pcm, every frame forced IDR; and a 60x34 frame that needs the
  crop), whose reconstruction is the source; P frames under force_pcm
  raise in both Encoders."""

import numpy as np
import pytest
from test_inter_e2e import moving_frames
from torch_parity import assert_same_output, both, encode_all, ippp, \
    refdec_matches

from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder.encoder import TYPE_IDR, TYPE_P, Picture
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder.encoder import Encoder

W, H = 64, 48     # ippp's size
SSIM_TOL = 1e-6


def _reconfig_at_2(enc, i):
    if i == 2:
        q = enc.p.copy()
        q.deblocking_filter = False
        q.keyint_max = 3
        enc.reconfig(q)


CASES = {
    "nr_cavlc": (dict(analyse__noise_reduction=200), 5, None),
    "nr_cabac": (dict(analyse__noise_reduction=200, cabac=True), 5, None),
    "ssim": (dict(analyse__ssim=True), 4, None),
    "reconfig": ({}, 7, _reconfig_at_2),
}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    over, n, before = CASES[request.param]
    r = both(lambda preset: ippp(preset, **over),
             moving_frames(n, W, H, seed=3), before)
    r["name"] = request.param
    return r


def test_option_stream_matches_x264_tpu(run):
    assert_same_output(run)
    assert run["enc"].stats["mb"]["P"] == run["jax_enc"].stats["mb"]["P"]


def test_option_refdec_decodes_port_stream(run):
    assert all(refdec_matches(run["got"][0], run["got"][1]))


def test_option_state_matches_x264_tpu(run):
    """What each option leaves behind beside the stream."""
    enc, jenc = run["enc"], run["jax_enc"]
    outs, jouts = run["got"][2], run["ref"][2]
    if run["name"].startswith("nr"):
        for a, b in zip(jenc._nr_state, enc._nr_state):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(enc._nr_state[2]).any()
    elif run["name"] == "ssim":
        for a, b in zip(jouts, outs):
            assert abs(a.ssim - b.ssim) <= SSIM_TOL
            assert 0.5 < b.ssim <= 1.0
        assert enc.stats["ssim_frames"] == jenc.stats["ssim_frames"] == 4
        assert abs(enc.stats["ssim_sum"] - jenc.stats["ssim_sum"]) \
            <= 4 * SSIM_TOL
    else:
        # frames 3 and 6 are IDR under keyint 3; the deblock is off from
        # the frame dispatched after the reconfig
        assert [o.i_type for o in outs] == [TYPE_IDR, TYPE_P, TYPE_P,
                                            TYPE_IDR, TYPE_P, TYPE_P,
                                            TYPE_IDR]
        assert not enc.p.deblocking_filter and enc.p.keyint_max == 3


# ------------------------------------------------------------------ PCM
def _noise_frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, s).astype(np.uint8)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for _ in range(n)]


def _pcm_encode(make, w, h, frames):
    p = make("ultrafast")
    p.width, p.height = w, h
    p.force_pcm = True
    p.full_recon = True
    p.threads = 1
    enc = (JaxEncoder(p) if make is jax_preset
           else Encoder(p, device="cpu"))
    from x264_tpu.entropy.nal import annexb_bytes
    stream = annexb_bytes(enc.headers())
    recons = []
    for i, f in enumerate(frames):
        nals, out = enc.encode(Picture(f, pts=i, i_type=TYPE_IDR))
        stream += annexb_bytes(nals)
        recons.append([np.asarray(r) for r in out.recon])
    return stream, recons


@pytest.mark.parametrize("w,h", [(64, 48), (60, 34)])
def test_pcm_matches_x264_tpu_and_decodes(w, h):
    frames = _noise_frames(3 if w == 64 else 2, w, h, seed=w)
    js, jrec = _pcm_encode(jax_preset, w, h, frames)
    ts, trec = _pcm_encode(param_default_preset, w, h, frames)
    assert ts == js
    for f, a, b in zip(frames, jrec, trec):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
            np.testing.assert_array_equal(f[c], b[c])  # recon == source
    assert all(refdec_matches(ts, trec))


def test_pcm_p_frame_raises_in_both():
    """x264_tpu's PCM mode is intra only: a P frame raises
    NotImplementedError there, and in the port."""
    frames = _noise_frames(2, W, H, seed=1)
    for make, enc_cls in ((jax_preset, JaxEncoder),
                          (param_default_preset, Encoder)):
        p = make("ultrafast")
        p.width, p.height = W, H
        p.force_pcm = True
        p.threads = 1
        enc = enc_cls(p) if enc_cls is JaxEncoder else enc_cls(p,
                                                               device="cpu")
        with pytest.raises(NotImplementedError, match="intra-only"):
            encode_all(enc, frames)
