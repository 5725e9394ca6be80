"""Video filter chain (reference: filters/video/*, vtable
filters/video/video.h:34-56).

Chain-of-responsibility like the reference: each filter wraps the previous
stage, exposes `info` and iterates frames (lists of numpy planes). The CLI
builds the chain from `--vf name:args/name:args` strings
(filters/video/video.c parsing) and auto-inserts `depth` when the source
bit depth exceeds the encoder's, mirroring the reference's auto-inserted
depth/resize converters (x264.c:1305 init_vid_filters).

Filters implemented: source (adapter), crop (crop.c:139), select_every
(select_every.c:158), resize (resize.c:612 — numpy area/bilinear scaler
instead of swscale), depth (depth.c:261 — 10->8 with deterministic
dither), cache (cache.c:151).
"""

from __future__ import annotations

import copy
from dataclasses import replace

import numpy as np

from .. import params as P


class SourceFilter:
    """Adapter over a demuxer/reader (filters/video/source.c)."""

    def __init__(self, reader) -> None:
        self._reader = reader
        self.info = reader.info

    def __iter__(self):
        return iter(self._reader)

    def close(self):
        self._reader.close()


def _chroma_div(csp):
    if csp == P.CSP_I420:
        return 2, 2
    if csp == P.CSP_I422:
        return 2, 1
    if csp == P.CSP_I444:
        return 1, 1
    return 1, 1     # I400 has no chroma planes


class CropFilter:
    """crop:left,top,right,bottom (reference filters/video/crop.c).

    Offsets are rounded down to chroma-sample alignment like the
    reference (crop.c handle_opts)."""

    def __init__(self, prev, left: int, top: int, right: int,
                 bottom: int) -> None:
        self._prev = prev
        dw, dh = _chroma_div(prev.info.csp)
        self._l = left - left % dw
        self._t = top - top % dh
        self._r = right - right % dw
        self._b = bottom - bottom % dh
        w = prev.info.width - self._l - self._r
        h = prev.info.height - self._t - self._b
        if w <= 0 or h <= 0:
            raise ValueError("crop: nothing left of the frame")
        self.info = replace(copy.copy(prev.info), width=w, height=h)

    def __iter__(self):
        dw, dh = _chroma_div(self._prev.info.csp)
        w, h = self.info.width, self.info.height
        for planes in self._prev:
            out = [planes[0][self._t:self._t + h, self._l:self._l + w]]
            for pl in planes[1:]:
                out.append(pl[self._t // dh:(self._t + h) // dh,
                              self._l // dw:(self._l + w) // dw])
            yield out

    def close(self):
        self._prev.close()


class SelectEveryFilter:
    """select_every:step,offset1[,offset2...]
    (reference filters/video/select_every.c)."""

    def __init__(self, prev, step: int, *offsets: int) -> None:
        self._prev = prev
        self._step = step
        self._offsets = sorted(set(offsets)) or [0]
        num, den = prev.info.fps_num * len(self._offsets), \
            prev.info.fps_den * step
        self.info = replace(copy.copy(prev.info), fps_num=num, fps_den=den)
        if prev.info.num_frames >= 0:
            full, rem = divmod(prev.info.num_frames, step)
            n = full * len(self._offsets) + sum(
                1 for o in self._offsets if o < rem)
            self.info = replace(self.info, num_frames=n)

    def __iter__(self):
        for i, planes in enumerate(self._prev):
            if i % self._step in self._offsets:
                yield planes

    def close(self):
        self._prev.close()


def _resize_plane(pl: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """Separable bilinear resample (replaces the reference's swscale)."""
    ih, iw = pl.shape
    if (ih, iw) == (oh, ow):
        return pl
    src = pl.astype(np.float32)
    # horizontal
    x = (np.arange(ow) + 0.5) * iw / ow - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, iw - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    fx = np.clip(x - x0, 0.0, 1.0).astype(np.float32)
    src = src[:, x0] * (1 - fx) + src[:, x1] * fx
    # vertical
    y = (np.arange(oh) + 0.5) * ih / oh - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, ih - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    fy = np.clip(y - y0, 0.0, 1.0).astype(np.float32)[:, None]
    out = src[y0] * (1 - fy) + src[y1] * fy
    hi = 1023 if pl.dtype == np.uint16 else 255
    return np.clip(np.rint(out), 0, hi).astype(pl.dtype)


class ResizeFilter:
    """resize:width=W,height=H (reference filters/video/resize.c, a
    swscale wrapper there; a numpy bilinear scaler here)."""

    def __init__(self, prev, width: int, height: int) -> None:
        self._prev = prev
        self.info = replace(copy.copy(prev.info), width=width,
                            height=height)

    def __iter__(self):
        dw, dh = _chroma_div(self.info.csp)
        w, h = self.info.width, self.info.height
        for planes in self._prev:
            out = [_resize_plane(planes[0], w, h)]
            for pl in planes[1:]:
                out.append(_resize_plane(pl, w // dw, h // dh))
            yield out

    def close(self):
        self._prev.close()


class DepthFilter:
    """depth:bit_depth=N (reference filters/video/depth.c). 10->8 uses the
    reference's deterministic ordered dither idea (depth.c dither_plane)
    re-expressed with a fixed 4x4 Bayer threshold matrix; 8->10 is a left
    shift (lossless)."""

    _BAYER4 = (np.array([[0, 8, 2, 10],
                         [12, 4, 14, 6],
                         [3, 11, 1, 9],
                         [15, 7, 13, 5]], np.int32) + 0.5) / 16.0

    def __init__(self, prev, bit_depth: int = 8, dither: bool = True)  \
            -> None:
        self._prev = prev
        self._out_depth = bit_depth
        self._dither = dither
        self.info = replace(copy.copy(prev.info), bitdepth=bit_depth)

    def _to8(self, pl: np.ndarray) -> np.ndarray:
        if pl.dtype == np.uint8:
            return pl
        if not self._dither:
            return np.clip((pl.astype(np.int32) + 2) >> 2, 0,
                           255).astype(np.uint8)
        h, w = pl.shape
        thr = np.tile(self._BAYER4,
                      ((h + 3) // 4, (w + 3) // 4))[:h, :w]
        v = pl.astype(np.float32) / 4.0
        return np.clip(np.floor(v + thr), 0, 255).astype(np.uint8)

    def __iter__(self):
        for planes in self._prev:
            if self._out_depth == 8:
                yield [self._to8(pl) for pl in planes]
            else:
                yield [(pl.astype(np.uint16) << 2) if pl.dtype == np.uint8
                       else pl for pl in planes]

    def close(self):
        self._prev.close()


class CacheFilter:
    """cache:N — keep the last N frames addressable (reference
    filters/video/cache.c). Iteration is pass-through; `get(i)` serves
    lookahead-style consumers."""

    def __init__(self, prev, size: int = 1) -> None:
        self._prev = prev
        self._size = max(1, size)
        self._buf: list = []
        self._base = 0
        self.info = prev.info

    def __iter__(self):
        for planes in self._prev:
            self._buf.append(planes)
            if len(self._buf) > self._size:
                self._buf.pop(0)
                self._base += 1
            yield planes

    def get(self, idx: int):
        """Frame idx if still cached, else None."""
        off = idx - self._base
        if 0 <= off < len(self._buf):
            return self._buf[off]
        return None

    def close(self):
        self._prev.close()


_FILTERS = {
    "crop": CropFilter,
    "select_every": SelectEveryFilter,
    "resize": ResizeFilter,
    "depth": DepthFilter,
    "cache": CacheFilter,
}


def build_chain(reader, spec: str | None):
    """Build source -> filters from a `--vf a:args/b:args` string
    (reference init_vid_filters, x264.c:1305; syntax video.c)."""
    chain = SourceFilter(reader)
    if spec:
        for part in spec.split("/"):
            part = part.strip()
            if not part:
                continue
            name, _, argstr = part.partition(":")
            name = name.strip().replace("-", "_")
            if name not in _FILTERS:
                raise ValueError(f"unknown video filter '{name}'")
            args: list = []
            kwargs: dict = {}
            if argstr:
                for a in argstr.split(","):
                    if "=" in a:
                        k, v = a.split("=", 1)
                        kwargs[k.strip()] = int(v)
                    else:
                        args.append(int(a))
            chain = _FILTERS[name](chain, *args, **kwargs)
    # auto-insert depth conversion while the encoder is 8-bit only
    # (reference auto-inserts depth/resize on mismatch, x264.c:1305)
    if chain.info.bitdepth > 8:
        chain = DepthFilter(chain, 8)
    return chain
