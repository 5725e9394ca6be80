"""The port's encode farm (x264_tpu_torch/encoder/farm.py) against
x264_tpu's (x264_tpu/encoder/farm.py) on the CPU, tolerance 0: 2 streams
of 3 frames (I P P) at 48x32 under tests/test_farm.py's `farm_params`.
Each stream's bytes equal x264_tpu's farm stream and the port's
single-stream Encoder's, and each frame position makes one batched
commit."""

import numpy as np
import pytest
import torch

from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder.farm import FarmEncoder as JaxFarm
from x264_tpu.entropy.nal import annexb_bytes as jax_annexb
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder import farm as tfarm
from x264_tpu_torch.encoder.encoder import Encoder, Picture
from x264_tpu_torch.entropy.nal import annexb_bytes

W, H, N, S = 48, 32, 3, 2


def stream_frames(seed):
    """tests/test_farm.py's clip at W x H."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(N):
        y = np.clip(120 + 70 * np.sin((xx + (2 + seed) * i) / 15)
                    * np.cos((yy + i) / 11)
                    + rng.integers(-5, 5, (H, W)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + seed + i) / 13), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - i) / 17), 0,
                    255).astype(np.uint8)
        out.append([y, u, v])
    return out


def farm_params(preset):
    """tests/test_farm.py's farm_params at W x H."""
    p = preset("medium")
    p.width, p.height = W, H
    p.cabac = False
    p.bframe = 0
    p.rc.rc_method = 0
    p.rc.qp_constant = 27
    p.analyse.psnr = False
    p.analyse.ssim = False
    p.analyse.weighted_pred = 0
    p.scenecut_threshold = 0
    p.keyint_max = 250
    p.threads = 1
    return p


def run_farm(farm, clips, annexb):
    streams = [annexb(farm.headers()) for _ in range(S)]
    for i in range(N):
        outs = farm.encode_batch([clips[s][i] for s in range(S)],
                                 idr=(i == 0))
        for s in range(S):
            streams[s] += annexb(outs[s])
    return streams


@pytest.fixture(scope="module")
def farms():
    clips = [stream_frames(s) for s in range(S)]
    ref = run_farm(JaxFarm(farm_params(jax_preset), S), clips, jax_annexb)
    calls = []
    real = tfarm.commit_batch

    def keep(items):
        calls.append(len(items))
        return real(items)

    tfarm.commit_batch = keep
    try:
        farm = tfarm.FarmEncoder(farm_params(param_default_preset), S,
                                 device="cpu")
        got = run_farm(farm, clips, annexb_bytes)
    finally:
        tfarm.commit_batch = real
    return clips, ref, got, calls


@pytest.mark.parametrize("s", range(S))
def test_farm_stream_matches_jax_farm(farms, s):
    _, ref, got, _ = farms
    assert got[s] == ref[s]


@pytest.mark.parametrize("s", range(S))
def test_farm_stream_matches_single_stream_encoder(farms, s):
    clips, _, got, _ = farms
    enc = Encoder(farm_params(param_default_preset), device="cpu")
    single = annexb_bytes(enc.headers())
    for i, f in enumerate(clips[s]):
        nals, _ = enc.encode(Picture(f, pts=i))
        single += annexb_bytes(nals)
    while enc.delayed_frames():
        nals, _ = enc.encode(None)
        single += annexb_bytes(nals)
    assert got[s] == single


def test_farm_commits_once_per_frame_position(farms):
    """One batched commit of all S streams per frame position (I and P:
    the farm's P frames carry intra in P)."""
    assert farms[3] == [S] * N


def test_farm_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfarm.FarmEncoder(farm_params(param_default_preset), S)
