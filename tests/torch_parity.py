"""Helpers of the clip tests that run one configuration through both
Encoders, x264_tpu's and the port's (tests/test_torch_presets*.py,
test_torch_options.py, test_torch_recovery.py, test_torch_bframe_clips.py,
test_torch_mbtree.py): encode a clip, compare what came out, decode the
port's stream with tools/refdec.py; and of the command-line tests
(tests/test_torch_cli*.py): write a y4m clip, run both CLIs on it."""

import os
import sys

import numpy as np

from x264_tpu import cli as jax_cli
from x264_tpu import param_default_preset as jax_preset
from x264_tpu.encoder.encoder import Encoder as JaxEncoder
from x264_tpu.encoder.encoder import Picture
from x264_tpu.entropy.nal import annexb_bytes
from x264_tpu_torch import cli as port_cli
from x264_tpu_torch import param_default_preset
from x264_tpu_torch.encoder.encoder import Encoder
from x264_tpu_torch.io.y4m import VideoInfo, Y4MWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import refdec  # noqa: E402


def ippp(preset, w=64, h=48, **over):
    """Preset medium at w x h, IPPP, CQP 26, CAVLC, no scene cut, no frame
    threads (tests/test_recovery.py's configuration), then `over`
    (a__b=v sets p.a.b = v)."""
    p = preset("medium")
    p.width, p.height = w, h
    p.cabac = False
    p.bframe = 0
    p.keyint_max = 250
    p.scenecut_threshold = 0
    p.rc.rc_method = 0
    p.rc.qp_constant = 26
    p.threads = 1
    for key, val in over.items():
        obj = p
        *path, last = key.split("__")
        for name in path:
            obj = getattr(obj, name)
        setattr(obj, last, val)
    return p


def bframe_params(preset, w=64, h=48, *, cabac=False, bframe=2, qp=26,
                  me_method=None, scenecut=None):
    """Preset medium at CQP with a fixed B run (bframe_adaptive 0)."""
    p = preset("medium")
    p.width, p.height = w, h
    p.cabac = cabac
    p.bframe = bframe
    p.bframe_adaptive = 0
    p.rc.rc_method = 0
    p.rc.qp_constant = qp
    p.full_recon = True
    if me_method is not None:
        p.analyse.me_method = me_method
    if scenecut is not None:
        p.scenecut_threshold = scenecut
    return p


def encode_stream(enc, frames):
    """Headers + every frame, drained -> (stream, [PicOut])."""
    stream = annexb_bytes(enc.headers())
    outs = []
    for i, f in enumerate(frames + [None]):
        while True:
            nals, out = enc.encode(None if f is None else Picture(f, pts=i))
            stream += annexb_bytes(nals)
            if out is not None:
                outs.append(out)
            if f is not None or out is None:
                break
    return stream, outs


def encode_all(enc, frames, before=None):
    """Headers + every frame, drained -> (stream, recon planes, PicOuts).
    before(enc, i), if given, runs ahead of the encode call of frame i."""
    stream = annexb_bytes(enc.headers())
    recons, outs = [], []
    for i, f in enumerate(frames + [None]):
        if before is not None and f is not None:
            before(enc, i)
        while True:
            nals, out = enc.encode(None if f is None else Picture(f, pts=i))
            stream += annexb_bytes(nals)
            if out is not None:
                recons.append([np.asarray(r) for r in out.recon])
                outs.append(out)
            if f is not None or out is None:
                break
    return stream, recons, outs


def both(make, frames, before=None):
    """make(preset_fn) -> Params, through x264_tpu's Encoder and the port's
    on the CPU -> {"ref": (stream, recons, outs), "got": ..., "jax_enc",
    "enc"}."""
    pj, pt = make(jax_preset), make(param_default_preset)
    pj.full_recon = pt.full_recon = True
    jax_enc = JaxEncoder(pj)
    ref = encode_all(jax_enc, frames, before)
    enc = Encoder(pt, device="cpu")
    got = encode_all(enc, frames, before)
    return dict(ref=ref, got=got, jax_enc=jax_enc, enc=enc)


def assert_same_output(run):
    """Bytes, frame types, pts, QPs, keyframe flags and reconstructions
    equal x264_tpu's."""
    (rs, rrec, routs), (gs, grec, gouts) = run["ref"], run["got"]
    for key in ("i_type", "pts", "dts", "qp", "b_keyframe"):
        assert ([getattr(o, key) for o in gouts]
                == [getattr(o, key) for o in routs]), key
    assert gs == rs
    assert len(grec) == len(rrec)
    for i, (a, b) in enumerate(zip(rrec, grec)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c],
                                          err_msg=f"frame {i} plane {c}")


def refdec_matches(stream, recons):
    """Per frame (coding order): does tools/refdec.py decode it to the
    encoder's reconstruction?"""
    decoded = refdec.Decoder().decode(stream)
    assert len(decoded) == len(recons)
    return [all(np.array_equal(d[c], r[c]) for c in range(3))
            for d, r in zip(decoded, recons)]


def write_clip(path, n=8, w=48, h=32, seed=0):
    """A y4m of a moving pattern with noise: n frames of w x h, 25 fps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wr = Y4MWriter(str(path), VideoInfo(w, h, 25, 1))
    for i in range(n):
        y = np.clip(120 + 70 * np.sin((xx + 3 * i) / 9) * np.cos((yy + i) / 7)
                    + rng.integers(-5, 5, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + i) / 5), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - i) / 6), 0,
                    255).astype(np.uint8)
        wr.write_frame([y, u, v])
    wr.close()


def cli_run(side, tmp, name, ext, extra):
    """x264_tpu's CLI (side "jax") or the port's on the CPU (side "port")
    on tmp/in.y4m with `extra` options, the reconstruction dumped ->
    (exit code, output bytes, dump-yuv bytes)."""
    mod, dev = ((jax_cli, []) if side == "jax"
                else (port_cli, ["--device", "cpu"]))
    out = tmp / f"{name}_{side}.{ext}"
    dump = tmp / f"{name}_{side}.y4m"
    rc = mod.main(dev + ["--quiet"] + extra + [
        "--dump-yuv", str(dump), "-o", str(out), str(tmp / "in.y4m")])
    return rc, out.read_bytes(), dump.read_bytes()


def cli_both(tmp, name, ext, extra):
    """cli_run on both sides -> {"jax": ..., "port": ...}."""
    return {side: cli_run(side, tmp, name, ext, extra)
            for side in ("jax", "port")}
