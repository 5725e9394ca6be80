"""The port's all-intra encoder end to end against x264_tpu: the same
frames and parameters through both Encoders must give byte-identical
streams and equal reconstructions, and the in-repo decoder (tools/refdec.py)
must decode the port's stream to the port's reconstruction."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x264_tpu import param_default_preset
from x264_tpu.encoder import lookahead as jlookahead
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu.encoder.encoder import Picture
from x264_tpu.entropy.nal import annexb_bytes
from x264_tpu_torch.convert import dpb_entry_from_numpy, dpb_entry_to_numpy
from x264_tpu_torch.encoder import lookahead as tlookahead
from x264_tpu_torch.encoder.encoder import Encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402


def synth_frames(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin(xx / 23 + i) * np.cos(yy / 17)
                    + rng.integers(-8, 8, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31 + i), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29 - i), 0,
                    255).astype(np.uint8)
        out.append([y, u, v])
    return out


def intra_params(w, h, qp):
    """Preset medium, all-intra (keyint 1), CQP, CAVLC; deblock and I_4x4
    stay on as the preset has them."""
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.keyint_max = 1
    p.cabac = False
    p.rc.rc_method = 0
    p.rc.qp_constant = qp
    p.full_recon = True
    return p


def encode_all(enc, frames):
    """Headers + every frame, drained; returns (stream, recon planes)."""
    stream = annexb_bytes(enc.headers())
    recons = []
    for i, f in enumerate(frames + [None]):
        while True:
            nals, out = enc.encode(None if f is None else Picture(f, pts=i))
            stream += annexb_bytes(nals)
            if out is not None:
                recons.append([np.asarray(r) for r in out.recon])
            if f is not None or out is None:
                break
    return stream, recons


@pytest.fixture(scope="module")
def clip3():
    """A 3-frame 64x48 all-intra clip through both encoders (qp 26: I
    frames at 23 through ip_factor)."""
    w, h = 64, 48
    frames = synth_frames(3, w, h)
    p = intra_params(w, h, 26)
    assert p.deblocking_filter
    jax_enc = JaxEncoder(p)
    ref = encode_all(jax_enc, frames)
    enc = Encoder(p, device="cpu")
    got = encode_all(enc, frames)
    return dict(frames=frames, ref=ref, got=got, jax_enc=jax_enc, enc=enc)


def test_stream_bytes_match_x264_tpu(clip3):
    assert clip3["got"][0] == clip3["ref"][0]


def test_reconstruction_matches_x264_tpu(clip3):
    assert len(clip3["got"][1]) == 3
    for a, b in zip(clip3["ref"][1], clip3["got"][1]):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])


def test_refdec_decodes_port_stream_to_its_recon(clip3):
    decoded = refdec.Decoder().decode(clip3["got"][0])
    assert len(decoded) == 3
    for i, (d, r) in enumerate(zip(decoded, clip3["got"][1])):
        for c in range(3):
            np.testing.assert_array_equal(d[c], r[c],
                                          err_msg=f"frame {i} plane {c}")


def test_avdec_decodes_port_stream_to_its_recon(clip3, tmp_path):
    """The second, independent oracle: libavcodec through tools/avdec."""
    avdec = os.path.join(ROOT, "tools", "avdec")
    if not os.path.exists(avdec):
        pytest.skip("tools/avdec not built (needs gcc and libavcodec)")
    bs, out = tmp_path / "port.264", tmp_path / "port.yuv"
    bs.write_bytes(clip3["got"][0])
    subprocess.run([avdec, str(bs), str(out)], check=True,
                   capture_output=True, timeout=120)
    raw = np.frombuffer(out.read_bytes(), np.uint8)
    w, h = 64, 48
    fsz = w * h * 3 // 2
    assert raw.size == 3 * fsz
    for i, rec in enumerate(clip3["got"][1]):
        f = raw[i * fsz:(i + 1) * fsz]
        planes = [f[:w * h].reshape(h, w),
                  f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                  f[w * h * 5 // 4:].reshape(h // 2, w // 2)]
        for c in range(3):
            np.testing.assert_array_equal(planes[c], rec[c],
                                          err_msg=f"frame {i} plane {c}")


def test_dpb_entries_match_x264_tpu(clip3):
    """The DPB push (pad_plane + hpel_planes) holds the same reference
    state in both encoders, and survives the numpy round trip."""
    jdpb, tdpb = clip3["jax_enc"]._dpb, clip3["enc"]._dpb
    assert len(jdpb) == len(tdpb) > 0
    for je, te in zip(jdpb, tdpb):
        tn = dpb_entry_to_numpy(te)
        for k in ("y_pad", "hpel", "cuv_pad", "mvf", "inter_mask"):
            np.testing.assert_array_equal(np.asarray(je[k]), tn[k],
                                          err_msg=k)
        for k in ("frame_num", "poc", "tag"):
            assert je[k] == te[k]
        back = dpb_entry_from_numpy(je, "cpu")
        for k in ("y_pad", "hpel", "cuv_pad"):
            assert torch.equal(back[k], te[k])


@pytest.mark.parametrize("qp", [8, 51])
def test_cropped_frame_matches_and_decodes(qp):
    w, h = 60, 36                      # not MB-aligned: the crop path
    frames = synth_frames(1, w, h, seed=9)
    ref = encode_all(JaxEncoder(intra_params(w, h, qp)), frames)
    got = encode_all(Encoder(intra_params(w, h, qp), device="cpu"), frames)
    assert got[0] == ref[0]
    decoded = refdec.Decoder().decode(got[0])
    for c in range(3):
        np.testing.assert_array_equal(ref[1][0][c], got[1][0][c])
        np.testing.assert_array_equal(decoded[0][c], got[1][0][c])


def test_lowres_and_intra_blocks_match_x264_tpu():
    y = synth_frames(1, 64, 48, seed=4)[0][0]
    low, phases = jlookahead.lowres_plane(jnp.asarray(y))
    tlow, tphases = tlookahead.lowres_plane(torch.from_numpy(y))
    np.testing.assert_array_equal(np.asarray(low), tlow.numpy())
    np.testing.assert_array_equal(np.asarray(phases), tphases.numpy())
    np.testing.assert_array_equal(
        np.asarray(jlookahead.intra_blocks(low)),
        tlookahead.intra_blocks(tlow).numpy())


def test_inter_frames_raise_not_implemented():
    """Options that raised NotImplementedError until they were ported. B
    frames, the exhaustive motion search and MB-tree encode (their parity
    is held in tests/test_torch_bframe.py and tests/test_torch_mbtree.py);
    periodic intra refresh and noise reduction encode byte-identical to
    x264_tpu, with equal reconstructions."""
    frames = synth_frames(3, 64, 48)
    for what in ("bframe", "me_method", "mb_tree", "intra_refresh",
                 "noise_reduction"):
        p = intra_params(64, 48, 26)
        p.keyint_max = 250
        p.bframe = 0
        if what == "bframe":
            p.bframe = 2
            p.bframe_adaptive = 0      # B_ADAPT_NONE: B frames, always
        elif what == "me_method":
            p.analyse.me_method = 3
        elif what == "mb_tree":
            p.rc.rc_method = 1         # CRF: the one mode that keeps MB-tree
            p.rc.mb_tree = True
        elif what == "intra_refresh":
            p.intra_refresh = True
        else:
            p.analyse.noise_reduction = 100
        got = encode_all(Encoder(p, device="cpu"), frames)
        assert len(got[1]) == 3
        if what in ("intra_refresh", "noise_reduction"):
            ref = encode_all(JaxEncoder(p), frames)
            assert got[0] == ref[0], what
            for a, b in zip(ref[1], got[1]):
                for c in range(3):
                    np.testing.assert_array_equal(a[c], b[c], err_msg=what)


def test_import_leaves_jax_out():
    """Every port module and chip_smoke import neither jax nor any module
    of the x264_tpu package (the port keeps its own host modules); the
    walk reaches the command line, the io modules, the farm and the mesh."""
    new = ["cli", "encoder.farm", "parallel.mesh"] + [
        "io." + m for m in ("y4m", "output", "mux", "timecode", "filters",
                            "thread_input", "lavf")]
    code = ("import pkgutil, importlib, sys\n"
            "import x264_tpu_torch\n"
            "for m in pkgutil.walk_packages(x264_tpu_torch.__path__,\n"
            "                                'x264_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            f"new = {new!r}\n"
            "missed = [m for m in new if 'x264_tpu_torch.' + m\n"
            "          not in sys.modules]\n"
            "assert not missed, missed\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "bad = [m for m in sys.modules if m == 'x264_tpu'\n"
            "       or m.startswith('x264_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_cuda_encoder_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(intra_params(64, 48, 26), device="cuda")
