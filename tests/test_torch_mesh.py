"""The port's (stream, band) layout (x264_tpu_torch/parallel/mesh.py)
against x264_tpu's on the 8-device virtual CPU mesh that tests/conftest.py
provides, tolerance 0: 2 streams x 4 slice bands of 2 MB rows, 64 wide.
The intra step and the P step give equal words, bit counts and
reconstructions; the assembled band NALs are equal bytes and decode in
libavcodec, as tests/test_mesh.py decodes them, to the reconstruction;
tools/refdec.py, which decodes no multi-slice stream, decodes each intra
band as a frame of its own."""

import subprocess

import jax
import numpy as np
import pytest
import torch

from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder.encoder import validate_parameters as jax_validate
from x264_tpu.entropy.nal import annexb_bytes as jax_annexb
from x264_tpu.parallel import mesh as jmesh
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder.encoder import validate_parameters
from x264_tpu_torch.entropy import sets
from x264_tpu_torch.entropy.nal import (NAL_PPS, NAL_PRIORITY_HIGHEST,
                                        NAL_SPS, annexb_bytes, nal_encode)
from x264_tpu_torch.ops import commit as tcommit
from x264_tpu_torch.parallel import mesh as tmesh
from torch_parity import ROOT, refdec

W, BAND_MB_ROWS, QP = 64, 2, 28
AVDEC = f"{ROOT}/tools/avdec"


def synth_frames(n, w, h, seed):
    """tests/test_mesh.py's clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin((xx + 2 * i) / 23) * np.cos(yy / 17)
                    + rng.integers(-6, 6, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31 + i), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29 - i), 0,
                    255).astype(np.uint8)
        out.append([y, u, v])
    return out


def params(preset, h):
    """tests/test_mesh.py's parameters."""
    p = preset("medium")
    p.width, p.height = W, h
    p.cabac = False
    p.bframe = 0
    p.rc.rc_method = 0
    p.rc.qp_constant = QP
    return p


def full_planes(recon, s):
    """A stream's banded reconstruction ([S, NB, rows, W] per plane) as
    whole [y, u, v] planes."""
    return [np.concatenate(np.asarray(r[s]), axis=0) for r in recon]


def host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def runs():
    jm = jmesh.make_mesh(8, devices=jax.devices("cpu")[:8])
    tm = tmesh.make_mesh(8, devices="cpu")
    s, nb = tm.shape
    h = nb * BAND_MB_ROWS * 16
    frames = synth_frames(2 * s, W, h, seed=2)
    i_frames, p_frames = frames[:s], frames[s:]
    ji = jmesh.sharded_intra_encode(jm, i_frames, qp=QP,
                                    band_mb_rows=BAND_MB_ROWS)
    launches = tcommit.commit.launches
    calls = []
    real = tmesh.commit_batch

    def keep(items):
        calls.append(len(items))
        return real(items)

    tmesh.commit_batch = keep
    try:
        ti = tmesh.sharded_intra_encode(tm, i_frames, qp=QP,
                                        band_mb_rows=BAND_MB_ROWS)
        refs = [full_planes(ti[2], si) for si in range(s)]
        jp = jmesh.sharded_pframe_encode(jm, p_frames, refs, qp=QP,
                                         band_mb_rows=BAND_MB_ROWS)
        tp = tmesh.sharded_pframe_encode(tm, p_frames, refs, qp=QP,
                                         band_mb_rows=BAND_MB_ROWS)
    finally:
        tmesh.commit_batch = real
    assert tcommit.commit.launches == launches   # CPU: the plain version
    return dict(jm=jm, tm=tm, h=h, ji=ji, ti=ti, jp=jp, tp=tp,
                calls=calls, refs=refs)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match(n):
    jm = jmesh.make_mesh(n, devices=jax.devices("cpu")[:n])
    tm = tmesh.make_mesh(n, devices="cpu")
    assert tm.devices.shape == jm.devices.shape
    assert tm.axis_names == jm.axis_names == ("stream", "band")
    assert all(d == torch.device("cpu") for d in tm.devices.flat)


def test_make_mesh_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(8)


@pytest.mark.parametrize("step", ["intra", "pframe"])
def test_sharded_step_matches_jax(runs, step):
    key = "i" if step == "intra" else "p"
    ref, got = runs["j" + key], runs["t" + key]
    np.testing.assert_array_equal(host(got[1]), np.asarray(ref[1]))
    jw, tw = np.asarray(ref[0]), host(got[0])
    assert tw.shape == jw.shape
    bits = np.asarray(ref[1])
    for si in range(bits.shape[0]):
        for b in range(bits.shape[1]):
            n_words = (int(bits[si, b]) + 31) // 32
            np.testing.assert_array_equal(
                tw[si, b, :n_words].astype(np.uint32),
                jw[si, b, :n_words].astype(np.uint32))
    for c in range(3):
        np.testing.assert_array_equal(host(got[2][c]), np.asarray(ref[2][c]))


def test_intra_step_is_one_batched_commit(runs):
    """The I step commits all streams x bands in one call; the P step,
    without intra in P, commits nothing."""
    s, nb = runs["tm"].shape
    assert runs["calls"] == [s * nb]


def _headers(w, h):
    p = validate_parameters(params(param_default_preset, h))
    p.width = w
    sps = sets.sps_init(p, p.sps_id)
    pps = sets.pps_init(p, sps, p.sps_id)
    return p, annexb_bytes([
        nal_encode(NAL_SPS, NAL_PRIORITY_HIGHEST, sets.sps_write(sps)),
        nal_encode(NAL_PPS, NAL_PRIORITY_HIGHEST, sets.pps_write(pps))])


def _stream_bytes(runs, si, jax_side):
    """Headers, the banded IDR (no deblock) and the banded P frame
    (deblock inside each slice) of stream si, by x264_tpu's or the port's
    assemble_band_nals."""
    h = runs["h"]
    mod, key, pre = ((jmesh, "j", jax_preset) if jax_side
                     else (tmesh, "t", param_default_preset))
    p = (jax_validate if jax_side else validate_parameters)(params(pre, h))
    _, stream = _headers(W, h)
    i_out, p_out = runs[key + "i"], runs[key + "p"]
    conv = np.asarray if jax_side else (lambda t: t)
    nals = mod.assemble_band_nals(
        p, conv(i_out[0])[si], conv(i_out[1])[si],
        band_mb_rows=BAND_MB_ROWS, slice_qp=QP, deblock_idc=1)
    nals += mod.assemble_band_nals(
        p, conv(p_out[0])[si], conv(p_out[1])[si],
        band_mb_rows=BAND_MB_ROWS, slice_qp=QP, frame_num=1, poc=2,
        idr=False, ptype=True, deblock_idc=2)
    return stream + (jax_annexb if jax_side else annexb_bytes)(nals)


@pytest.mark.parametrize("si", range(2))
def test_assembled_band_nals_match_jax(runs, si):
    assert _stream_bytes(runs, si, False) == _stream_bytes(runs, si, True)


def _avdec(stream, w, h, n, tmp_path, name):
    f264 = tmp_path / f"{name}.264"
    f264.write_bytes(stream)
    out = tmp_path / f"{name}.yuv"
    r = subprocess.run([AVDEC, str(f264), str(out), str(n * 4)],
                       capture_output=True, text=True)
    assert "error" not in r.stderr.lower(), r.stderr
    raw = out.read_bytes()
    fsz = w * h * 3 // 2
    assert len(raw) >= n * fsz
    frames = []
    for i in range(n):
        fr = raw[i * fsz:(i + 1) * fsz]
        frames.append([
            np.frombuffer(fr[:w * h], np.uint8).reshape(h, w),
            np.frombuffer(fr[w * h:w * h * 5 // 4],
                          np.uint8).reshape(h // 2, w // 2),
            np.frombuffer(fr[w * h * 5 // 4:], np.uint8).reshape(
                h // 2, w // 2)])
    return frames


@pytest.mark.parametrize("si", range(2))
def test_intra_bands_decode_in_refdec(runs, si):
    """tools/refdec.py decodes no multi-slice stream (ROADMAP section 3,
    F7), but a band of the intra step is coded as a frame of its own: its
    slice, as the first slice of a W x band-height picture, decodes to the
    band's reconstruction."""
    words, bits, recon, _ = runs["ti"]
    p, hdr = _headers(W, BAND_MB_ROWS * 16)
    for b in range(bits.shape[1]):
        nals = tmesh.assemble_band_nals(
            p, words[si, b:b + 1], bits[si, b:b + 1],
            band_mb_rows=BAND_MB_ROWS, slice_qp=QP, deblock_idc=1)
        decoded = refdec.Decoder().decode(hdr + annexb_bytes(nals))
        assert len(decoded) == 1
        for c in range(3):
            np.testing.assert_array_equal(
                decoded[0][c], host(recon[c][si, b]),
                err_msg=f"band {b} plane {c}")


@pytest.mark.parametrize("si", range(2))
def test_assembled_band_nals_decode_in_libavcodec(runs, si, tmp_path):
    """The banded IDR and the banded P frame of a stream decode in
    libavcodec to the reconstruction, as tests/test_mesh.py checks."""
    import os
    if not os.path.exists(AVDEC):
        pytest.skip("libavcodec not available")
    h = runs["h"]
    stream = _stream_bytes(runs, si, False)
    recons = [full_planes(runs["ti"][2], si), full_planes(runs["tp"][2], si)]
    for i, fr in enumerate(_avdec(stream, W, h, 2, tmp_path, f"mesh{si}")):
        for c in range(3):
            np.testing.assert_array_equal(fr[c], recons[i][c],
                                          err_msg=f"frame {i} plane {c}")
