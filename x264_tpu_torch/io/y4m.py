"""YUV4MPEG2 demuxer/muxer (reference: input/y4m.c, 370 LoC).

Reads planar frames into numpy arrays. Supports C420 (all variants map to
centre/left siting — siting only affects metadata), C422, C444, Cmono, and
10-bit (p10) variants.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from fractions import Fraction
from typing import BinaryIO, Iterator, Optional

import numpy as np

from .. import params as P


@dataclass
class VideoInfo:
    width: int
    height: int
    fps_num: int
    fps_den: int
    sar_width: int = 0
    sar_height: int = 0
    csp: int = P.CSP_I420
    bitdepth: int = 8
    interlaced: bool = False
    tff: bool = False
    num_frames: int = -1     # -1 = unknown


_CSP_MAP = {
    "420": (P.CSP_I420, 8), "420jpeg": (P.CSP_I420, 8),
    "420mpeg2": (P.CSP_I420, 8), "420paldv": (P.CSP_I420, 8),
    "422": (P.CSP_I422, 8), "444": (P.CSP_I444, 8),
    "mono": (P.CSP_I400, 8),
    "420p10": (P.CSP_I420, 10), "422p10": (P.CSP_I422, 10),
    "444p10": (P.CSP_I444, 10), "mono10": (P.CSP_I400, 10),
}


def _plane_shapes(w: int, h: int, csp: int):
    if csp == P.CSP_I400:
        return [(h, w)]
    if csp == P.CSP_I420:
        return [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    if csp == P.CSP_I422:
        return [(h, w), (h, w // 2), (h, w // 2)]
    if csp == P.CSP_I444:
        return [(h, w), (h, w), (h, w)]
    raise ValueError(f"unsupported csp {csp}")


class Y4MReader:
    """Iterates frames as lists of numpy planes [Y, (U, V)]."""

    def __init__(self, path_or_file) -> None:
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        header = self._readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("not a y4m file")
        w = h = 0
        fps = Fraction(25, 1)
        sar = (0, 0)
        csp, depth = P.CSP_I420, 8
        interlaced, tff = False, False
        for tok in header.split()[1:]:
            tag, val = chr(tok[0]), tok[1:].decode()
            if tag == "W":
                w = int(val)
            elif tag == "H":
                h = int(val)
            elif tag == "F":
                n, d = val.split(":")
                fps = Fraction(int(n), int(d))
            elif tag == "A":
                n, d = val.split(":")
                sar = (int(n), int(d))
            elif tag == "C":
                key = val.lower()
                if key not in _CSP_MAP:
                    raise ValueError(f"unsupported y4m colourspace {val}")
                csp, depth = _CSP_MAP[key]
            elif tag == "I":
                interlaced = val in ("t", "b")
                tff = val == "t"
        self.info = VideoInfo(w, h, fps.numerator, fps.denominator,
                              sar[0], sar[1], csp, depth, interlaced, tff)
        self._shapes = _plane_shapes(w, h, csp)
        self._dtype = np.uint8 if depth == 8 else np.uint16
        self._frame_bytes = sum(a * b for a, b in self._shapes) * (
            1 if depth == 8 else 2)
        # frame count if seekable
        try:
            pos = self._f.tell()
            self._f.seek(0, 2)
            size = self._f.tell()
            self._f.seek(pos)
            per = self._frame_bytes + 6  # 'FRAME\n'
            self.info.num_frames = max(0, (size - pos) // per)
        except OSError:
            pass

    def _readline(self) -> bytes:
        line = bytearray()
        while True:
            c = self._f.read(1)
            if not c or c == b"\n":
                return bytes(line)
            line += c

    def read_frame(self) -> Optional[list[np.ndarray]]:
        hdr = self._readline()
        if not hdr:
            return None
        if not hdr.startswith(b"FRAME"):
            raise ValueError("bad y4m frame header")
        planes = []
        for shape in self._shapes:
            n = shape[0] * shape[1] * self._dtype().itemsize
            buf = self._f.read(n)
            if len(buf) < n:
                return None
            planes.append(np.frombuffer(buf, self._dtype).reshape(shape))
        return planes

    def __iter__(self) -> Iterator[list[np.ndarray]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self) -> None:
        if self._own:
            self._f.close()


class Y4MWriter:
    """Writes y4m (used by --dump-yuv equivalents and tests)."""

    def __init__(self, path, info: VideoInfo) -> None:
        self._f = open(path, "wb") if isinstance(path, (str, os.PathLike)) \
            else path
        self.info = info
        csp_tag = {P.CSP_I420: "420", P.CSP_I422: "422",
                   P.CSP_I444: "444", P.CSP_I400: "mono"}[info.csp]
        if info.bitdepth == 10:
            csp_tag += "p10" if info.csp != P.CSP_I400 else "10"
        hdr = f"YUV4MPEG2 W{info.width} H{info.height} " \
              f"F{info.fps_num}:{info.fps_den} Ip A0:0 C{csp_tag}\n"
        self._f.write(hdr.encode())

    def write_frame(self, planes: list[np.ndarray]) -> None:
        self._f.write(b"FRAME\n")
        for pl in planes:
            self._f.write(np.ascontiguousarray(pl).tobytes())

    def close(self) -> None:
        self._f.close()


class RawReader:
    """Raw YUV input (reference: input/raw.c). Needs explicit geometry."""

    def __init__(self, path, width: int, height: int,
                 csp: int = P.CSP_I420, bitdepth: int = 8,
                 fps: tuple[int, int] = (25, 1)) -> None:
        self._f = open(path, "rb")
        self.info = VideoInfo(width, height, fps[0], fps[1], csp=csp,
                              bitdepth=bitdepth)
        self._shapes = _plane_shapes(width, height, csp)
        self._dtype = np.uint8 if bitdepth == 8 else np.uint16
        fb = sum(a * b for a, b in self._shapes) * self._dtype().itemsize
        self._f.seek(0, 2)
        self.info.num_frames = self._f.tell() // fb
        self._f.seek(0)

    def read_frame(self) -> Optional[list[np.ndarray]]:
        planes = []
        for shape in self._shapes:
            n = shape[0] * shape[1] * self._dtype().itemsize
            buf = self._f.read(n)
            if len(buf) < n:
                return None
            planes.append(np.frombuffer(buf, self._dtype).reshape(shape))
        return planes

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self) -> None:
        self._f.close()


def open_input(path: str, **kwargs):
    """Probe by extension (reference: select_input x264.c:1228); lavf is
    the anything-else fallback like the reference CLI."""
    if str(path).endswith(".y4m"):
        return Y4MReader(path)
    if str(path).endswith((".yuv", ".raw")) or "width" in kwargs:
        return RawReader(path, **kwargs)
    from .lavf import LavfReader
    return LavfReader(path)
