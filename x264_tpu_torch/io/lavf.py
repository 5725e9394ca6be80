"""lavf input demuxer: any container/codec ffmpeg can read.

TPU-native analogue of the reference's input/lavf.c (280 LoC): a thin
ctypes bridge to native/lavf_in.c (libavformat demux + libavcodec decode
+ swscale CSP normalization). Non-YUV sources are converted to yuv420p,
matching the reference CLI's auto-inserted CSP filter (x264.c:1305).

Frames are surfaced as numpy plane lists; per-frame pts (stream timebase)
is retained on the reader for VFR passthrough (input/lavf.c converts pts
into the demuxer timebase the same way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from .. import params as P
from .y4m import VideoInfo

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_NATIVE_DIR, "lavf_in.c")

_lib = None


class _LavfInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("fps_num", ctypes.c_int32), ("fps_den", ctypes.c_int32),
        ("sar_num", ctypes.c_int32), ("sar_den", ctypes.c_int32),
        ("tb_num", ctypes.c_int32), ("tb_den", ctypes.c_int32),
        ("csp", ctypes.c_int32), ("bitdepth", ctypes.c_int32),
        ("num_frames", ctypes.c_int64),
        ("interlaced", ctypes.c_int32), ("tff", ctypes.c_int32),
    ]


def available() -> bool:
    try:
        return _load() is not None
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_NATIVE_DIR, "..", "_build", f"liblavf-{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["gcc", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC,
             "-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
            check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.lavf_open.restype = ctypes.c_void_p
    lib.lavf_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.POINTER(_LavfInfo)]
    lib.lavf_read.restype = ctypes.c_int
    lib.lavf_read.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint8)] * 3 + \
        [ctypes.POINTER(ctypes.c_int64)]
    lib.lavf_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


_CSP_FROM_C = {420: P.CSP_I420, 422: P.CSP_I422, 444: P.CSP_I444,
               400: P.CSP_I400}


class LavfReader:
    """Iterates decoded frames as numpy plane lists (like Y4MReader)."""

    def __init__(self, path: str, format_name: str | None = None) -> None:
        lib = _load()
        ci = _LavfInfo()
        self._h = lib.lavf_open(
            os.fsencode(path), (format_name or "").encode(),
            ctypes.byref(ci))
        if not self._h:
            raise IOError(f"lavf: cannot open {path!r}")
        self._lib = lib
        self.info = VideoInfo(
            width=ci.width, height=ci.height,
            fps_num=ci.fps_num, fps_den=ci.fps_den,
            sar_width=ci.sar_num, sar_height=ci.sar_den,
            csp=_CSP_FROM_C[ci.csp], bitdepth=ci.bitdepth,
            interlaced=bool(ci.interlaced), tff=bool(ci.tff),
            num_frames=int(ci.num_frames))
        self.timebase = (ci.tb_num, ci.tb_den)
        self.pts: list[int] = []
        w, hgt = ci.width, ci.height
        if ci.csp == 400:
            shapes = [(hgt, w)]
        elif ci.csp == 420:
            shapes = [(hgt, w), ((hgt + 1) // 2, (w + 1) // 2),
                      ((hgt + 1) // 2, (w + 1) // 2)]
        elif ci.csp == 422:
            shapes = [(hgt, w), (hgt, (w + 1) // 2), (hgt, (w + 1) // 2)]
        else:
            shapes = [(hgt, w)] * 3
        self._shapes = shapes
        self._dtype = np.uint16 if ci.bitdepth > 8 else np.uint8

    def read_frame(self):
        bufs = [np.empty(s, self._dtype) for s in self._shapes]
        while len(bufs) < 3:
            bufs.append(np.empty(0, self._dtype))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        pts = ctypes.c_int64()
        r = self._lib.lavf_read(
            self._h, *[b.ctypes.data_as(u8p) for b in bufs[:3]],
            ctypes.byref(pts))
        if r == 0:
            return None
        if r < 0:
            raise IOError("lavf: decode error")
        self.pts.append(int(pts.value))
        n = 1 if self.info.csp == P.CSP_I400 else 3
        return [bufs[i] for i in range(n)]

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self) -> None:
        if self._h:
            self._lib.lavf_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
