"""The port's inputs, filters and muxers (x264_tpu_torch/io/*) against
x264_tpu's (x264_tpu/io/*), tolerance 0. The io modules are line-for-line
copies (lavf.py differs in its source and build paths only, and
csrc/lavf_in.c is a byte copy of native/lavf_in.c); fed the same NAL
lists, frames and timecode files, both sides write the same bytes and
read the same frames."""

import inspect
import os

import numpy as np
import pytest

from x264_tpu import param_default_preset as jax_preset
from x264_tpu.entropy import nal as jnal
from x264_tpu.io import filters as jfilters
from x264_tpu.io import lavf as jlavf
from x264_tpu.io import mux as jmux
from x264_tpu.io import output as joutput
from x264_tpu.io import thread_input as jthread
from x264_tpu.io import timecode as jtc
from x264_tpu.io import y4m as jy4m
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder.encoder import Encoder, Picture
from x264_tpu_torch.io import filters as tfilters
from x264_tpu_torch.io import lavf as tlavf
from x264_tpu_torch.io import mux as tmux
from x264_tpu_torch.io import output as toutput
from x264_tpu_torch.io import thread_input as tthread
from x264_tpu_torch.io import timecode as ttc
from x264_tpu_torch.io import y4m as ty4m
from torch_parity import ROOT

W, H = 64, 48
COPIES = [(jfilters, tfilters), (jmux, tmux), (joutput, toutput),
          (jthread, tthread), (jtc, ttc), (jy4m, ty4m)]


@pytest.mark.parametrize("pair", COPIES, ids=lambda p: p[0].__name__)
def test_io_module_is_a_copy(pair):
    assert inspect.getsource(pair[1]) == inspect.getsource(pair[0])


def test_lavf_differs_in_its_two_path_lines_only():
    ref = inspect.getsource(jlavf).split("\n")
    got = inspect.getsource(tlavf).split("\n")
    assert len(got) == len(ref)
    differ = [i + 1 for i, (a, b) in enumerate(zip(ref, got)) if a != b]
    assert differ == [26, 57]
    assert os.path.normpath(tlavf._SRC) == os.path.join(
        ROOT, "x264_tpu_torch", "csrc", "lavf_in.c")
    assert "_build" in got[56] and "native" not in got[56]


def test_lavf_source_is_a_byte_copy():
    with open(os.path.join(ROOT, "native", "lavf_in.c"), "rb") as f:
        ref = f.read()
    with open(tlavf._SRC, "rb") as f:
        assert f.read() == ref


# ---------------------------------------------------------------- muxers
@pytest.fixture(scope="module")
def coded():
    """An IBBP clip through the port's Encoder on the CPU: per access
    unit (NALs, pts, dts), and the headers."""
    p = param_default_preset("medium")
    p.width, p.height = W, H
    p.cabac = False
    p.bframe = 2
    p.bframe_adaptive = 0
    p.rc.rc_method = 0
    p.rc.qp_constant = 30
    enc = Encoder(p, device="cpu")
    rng = np.random.default_rng(3)
    aus = []
    frames = [[rng.integers(0, 256, (H, W), np.uint8),
               rng.integers(0, 256, (H // 2, W // 2), np.uint8),
               rng.integers(0, 256, (H // 2, W // 2), np.uint8)]
              for _ in range(5)]
    for i, f in enumerate(frames + [None] * 4):
        nals, out = enc.encode(None if f is None else Picture(f, pts=i))
        if nals:
            aus.append((nals, out.pts, out.dts))
    return enc.headers(), aus


def _mux(side, path, muxer, headers, aus):
    open_output, preset, to_nal = (
        (joutput.open_output, jax_preset,
         lambda n: jnal.NAL(n.type, n.ref_idc, n.payload,
                            n.b_long_startcode))
        if side == "jax" else (toutput.open_output, param_default_preset,
                               lambda n: n))
    p = preset("medium")
    p.width, p.height = W, H
    out = open_output(str(path), muxer)
    out.set_param(p)
    out.write_headers([to_nal(n) for n in headers])
    for nals, pts, dts in aus:
        out.write_frame([to_nal(n) for n in nals], pts=pts, dts=dts)
    out.close()
    return path.read_bytes()


@pytest.mark.parametrize("ext,muxer", [("264", None), ("mkv", None),
                                       ("mp4", None), ("flv", "flv"),
                                       ("mov", None)])
def test_muxers_write_the_same_bytes(coded, tmp_path, ext, muxer):
    headers, aus = coded
    assert any(dts != pts for _, pts, dts in aus)   # B frames reorder
    ref = _mux("jax", tmp_path / f"j.{ext}", muxer, headers, aus)
    got = _mux("port", tmp_path / f"t.{ext}", muxer, headers, aus)
    assert got == ref and len(got) > 0


# ------------------------------------------------------------ y4m and raw
def _frames(n, w, h, seed, depth=8):
    rng = np.random.default_rng(seed)
    dt, hi = (np.uint8, 256) if depth == 8 else (np.uint16, 1024)
    return [[rng.integers(0, hi, (h, w)).astype(dt),
             rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
             rng.integers(0, hi, (h // 2, w // 2)).astype(dt)]
            for _ in range(n)]


@pytest.mark.parametrize("fps", [(25, 1), (30000, 1001)])
def test_y4m_write_and_read_alike(tmp_path, fps):
    frames = _frames(3, 48, 32, seed=1)
    data = {}
    for side, mod in (("jax", jy4m), ("port", ty4m)):
        path = tmp_path / f"{side}.y4m"
        wr = mod.Y4MWriter(str(path), mod.VideoInfo(48, 32, *fps))
        for f in frames:
            wr.write_frame(f)
        wr.close()
        data[side] = path.read_bytes()
    assert data["port"] == data["jax"]
    path = tmp_path / "jax.y4m"
    jr, tr = jy4m.Y4MReader(str(path)), ty4m.Y4MReader(str(path))
    assert vars(tr.info) == vars(jr.info)
    for a, b in zip(jr, tr, strict=True):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    jr.close()
    tr.close()


def test_raw_reader_reads_alike(tmp_path):
    frames = _frames(2, 32, 16, seed=2)
    path = tmp_path / "in.yuv"
    path.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    jr = jy4m.RawReader(str(path), 32, 16, fps=(24, 1))
    tr = ty4m.RawReader(str(path), 32, 16, fps=(24, 1))
    assert vars(tr.info) == vars(jr.info)
    for a, b in zip(jr, tr, strict=True):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])


# ---------------------------------------------------------------- filters
class FakeReader:
    """tests/test_filters.py's source."""

    def __init__(self, mod, n=6, w=64, h=48, depth=8):
        self.frames = _frames(n, w, h, seed=0, depth=depth)
        self.info = mod.VideoInfo(w, h, 30, 1, bitdepth=depth, num_frames=n)

    def __iter__(self):
        return iter(self.frames)

    def close(self):
        pass


@pytest.mark.parametrize("spec,depth", [
    ("crop:8,4,16,12", 8), ("select_every:3,0,2", 8),
    ("resize:width=32,height=24", 8), (None, 10),
    ("crop:0,0,32,24/resize:width=64,height=48", 8)])
def test_filter_chain_alike(spec, depth):
    outs = {}
    for side, fmod, ymod in (("jax", jfilters, jy4m),
                             ("port", tfilters, ty4m)):
        ch = fmod.build_chain(FakeReader(ymod, depth=depth), spec)
        outs[side] = (vars(ch.info), list(ch))
    assert outs["port"][0] == outs["jax"][0]
    assert len(outs["port"][1]) == len(outs["jax"][1])
    for a, b in zip(outs["jax"][1], outs["port"][1]):
        for c in range(3):
            assert a[c].dtype == b[c].dtype
            np.testing.assert_array_equal(a[c], b[c])


def test_threaded_reader_alike():
    got = {}
    for side, tmod, ymod in (("jax", jthread, jy4m),
                             ("port", tthread, ty4m)):
        tr = tmod.ThreadedReader(FakeReader(ymod, n=8), depth=2)
        got[side] = list(tr)
        tr.close()
    for a, b in zip(got["jax"], got["port"], strict=True):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])


# --------------------------------------------------------------- timecode
TCFILES = {
    "v2": "# timecode format v2\n0\n40\n60\n100\n",
    "v1": "# timecode format v1\nassume 25\n0,3,50\n",
    "v1_gap": "# timecode format v1\nAssume 25\n2,3,50\n",
}


@pytest.mark.parametrize("name", sorted(TCFILES))
def test_timecode_parse_and_map_alike(tmp_path, name):
    path = tmp_path / "tc.txt"
    path.write_text(TCFILES[name])
    assert ttc.parse_tcfile(str(path)) == jtc.parse_tcfile(str(path))
    jm = jtc.TimecodeMap(str(path), fallback_fps=(25, 1))
    tm = ttc.TimecodeMap(str(path), fallback_fps=(25, 1))
    assert [tm.pts(i) for i in range(-1, 8)] == [jm.pts(i)
                                                 for i in range(-1, 8)]


def test_timecode_writer_alike(tmp_path):
    data = {}
    for side, mod in (("jax", jtc), ("port", ttc)):
        path = tmp_path / f"{side}.txt"
        w = mod.TimecodeWriter(str(path), 1, 1000)
        for t in (0, 80, 40, 120, 160):
            w.add(t)
        w.close()
        data[side] = path.read_bytes()
    assert data["port"] == data["jax"]


def test_timecode_errors_alike(tmp_path):
    path = tmp_path / "tc.txt"
    path.write_text("# timecode format v2\n0\n40\n30\n")
    for mod in (jtc, ttc):
        with pytest.raises(mod.TimecodeError):
            mod.parse_tcfile(str(path))


# ------------------------------------------------------------------- lavf
@pytest.fixture
def lavf_available():
    if not tlavf.available():
        pytest.skip("libavformat not available")


def test_lavf_reads_y4m_like_the_y4m_reader(lavf_available, tmp_path):
    """As tests/test_lavf.py: lavf's yuv4mpegpipe demuxer gives the frames
    of the port's own Y4M reader."""
    frames = _frames(4, 64, 48, seed=4)
    path = str(tmp_path / "in.y4m")
    wr = ty4m.Y4MWriter(path, ty4m.VideoInfo(64, 48, 30000, 1001))
    for f in frames:
        wr.write_frame(f)
    wr.close()
    rd = tlavf.LavfReader(path)
    got = list(rd)
    rd.close()
    assert len(got) == len(frames)
    for a, b in zip(frames, got):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
