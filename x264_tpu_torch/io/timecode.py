"""Timecode file input/output (VFR): tcfile v1/v2.

Reference: input/timecode.c (parse_tcfile:96, correct_fps:55,
try_mkv_timebase_den:80) and the x264.c --tcfile-in/--tcfile-out/
--timebase flow (x264.c:1720, write 'timecode format v2' at x264.c:1663).

Design: where the reference juggles doubles + sigexp10 to recover
rational fps values, this implementation keeps everything exact with
`fractions.Fraction`: each segment's fps is snapped to a rational
(NTSC-style x*1000/1001 rates detected first, like correct_fps), the
timebase is the LCM of the per-segment tick denominators (capped at the
MKV timebase 1e9 like the reference's fallback), and per-frame pts are
exact integer ticks.

Timebase semantics (x264.h i_timebase_num/den): seconds = pts * num/den.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Tuple

MKV_TIMEBASE_DEN = 1_000_000_000


class TimecodeError(ValueError):
    pass


def correct_fps(fps: float) -> Fraction:
    """Snap a decimal fps to its intended rational (reference
    correct_fps, input/timecode.c:55): try x/1001-denominator rates
    (23.976 -> 24000/1001, 29.97 -> 30000/1001, ...) before falling back
    to a plain decimal fraction."""
    if fps <= 0:
        raise TimecodeError(f"invalid fps {fps}")
    for mult in range(1, 101):
        num = fps * 1001 * mult
        if abs(num - round(num)) < 5e-4 * 1001 * mult:
            frac = Fraction(int(round(num)), 1001 * mult)
            if abs(float(frac) - fps) < 5e-6 * fps:
                return frac
    # plain decimal: up to 6 decimal places
    return Fraction(fps).limit_denominator(1_000_000)


def _is_comment(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith("#")


def parse_tcfile(path: str, fallback_fps: Tuple[int, int] = (25, 1),
                 timebase: Optional[Tuple[int, int]] = None,
                 n_frames: int = 0):
    """Parse a timecode file (v1 or v2).

    Returns (tb_num, tb_den, ticks list, extend_tick) where ticks[i] is
    frame i's pts in timebase units and extend_tick is the per-frame
    delta to use for frames past the end of the file.
    """
    with open(path) as f:
        lines = f.readlines()
    if not lines:
        raise TimecodeError("empty tcfile")
    head = lines[0].strip().lower()
    ver = None
    for tag in ("# timecode format v", "# timestamp format v"):
        if head.startswith(tag):
            ver = int(head[len(tag):].split()[0])
    if ver not in (1, 2):
        raise TimecodeError(f"unsupported timecode format: {lines[0]!r}")
    if ver == 1:
        return _parse_v1(lines[1:], timebase, n_frames)
    return _parse_v2(lines[1:], timebase, n_frames)


def _pick_timebase(ticks: List[Fraction],
                   timebase: Optional[Tuple[int, int]]):
    """Choose num/den so that every tick duration is an integer count.
    LCM of the tick denominators; capped at the MKV timebase like the
    reference's try_mkv_timebase_den fallback."""
    if timebase:
        return timebase
    den = 1
    for t in ticks:
        den = math.lcm(den, t.denominator)
        if den > MKV_TIMEBASE_DEN:
            return (1, MKV_TIMEBASE_DEN)
    return (1, den)


def _to_ticks(times: List[Fraction], tb: Tuple[int, int]) -> List[int]:
    num, den = tb
    scale = Fraction(den, num)
    return [int(round(t * scale)) for t in times]


def _parse_v1(body: List[str], timebase, n_frames: int):
    """v1: 'assume <fps>' then 'start,end,fps' ranges; uncovered frames
    run at the assumed fps (input/timecode.c:106-186)."""
    assume = None
    ranges: List[Tuple[int, int, Fraction]] = []
    last_frame = -1
    for ln in body:
        s = ln.strip()
        if _is_comment(s):
            # TDecimate hint fixes the total frame count
            low = s.lower()
            if "last frame" in low and "=" in low:
                try:
                    last_frame = int(low.split("=")[1].strip())
                except ValueError:
                    pass
            continue
        low = s.lower()
        if low.startswith("assume"):
            assume = correct_fps(float(s.split(None, 1)[1].lstrip(" =")))
            continue
        parts = s.split(",")
        if len(parts) != 3:
            raise TimecodeError(f"invalid v1 tcfile line: {s!r}")
        start, end = int(parts[0]), int(parts[1])
        fps = correct_fps(float(parts[2]))
        if ranges and start <= ranges[-1][1]:
            raise TimecodeError(f"overlapping v1 range at {s!r}")
        if start > end:
            raise TimecodeError(f"invalid v1 range at {s!r}")
        ranges.append((start, end, fps))
    if assume is None:
        raise TimecodeError("v1 tcfile: assumed fps not found")
    if last_frame < 0:
        last_frame = ranges[-1][1] + 1 if ranges else 0
    count = max(last_frame + 1, n_frames)

    # per-frame tick durations
    durs = [Fraction(1) / assume] * count
    for start, end, fps in ranges:
        for i in range(start, min(end + 1, count)):
            durs[i] = Fraction(1) / fps
    tb = _pick_timebase(durs + [Fraction(1) / assume], timebase)
    times = [Fraction(0)]
    for d in durs:
        times.append(times[-1] + d)
    ticks = _to_ticks(times[:count], tb)
    ext = _to_ticks([Fraction(1) / assume], tb)[0]
    return tb[0], tb[1], ticks, max(ext, 1)


def _parse_v2(body: List[str], timebase, n_frames: int):
    """v2: one timestamp per frame, milliseconds
    (input/timecode.c:228-264)."""
    stamps: List[Fraction] = []
    for ln in body:
        s = ln.strip()
        if _is_comment(s):
            continue
        # exact decimal parse: Fraction('12.345') keeps all digits
        try:
            ms = Fraction(s.split()[0])
        except (ValueError, ZeroDivisionError):
            raise TimecodeError(f"invalid v2 timestamp: {s!r}")
        t = ms / 1000
        if stamps and t <= stamps[-1]:
            raise TimecodeError(
                f"non-monotone v2 timestamp at frame {len(stamps)}")
        stamps.append(t)
    if not stamps:
        raise TimecodeError("tcfile has no timecodes")
    if len(stamps) == 1:
        stamps.append(stamps[0] + Fraction(1, 25))
    durs = [stamps[i + 1] - stamps[i] for i in range(len(stamps) - 1)]
    tb = _pick_timebase([stamps[0]] + durs, timebase)
    ticks = _to_ticks(stamps, tb)
    ext = max(ticks[-1] - ticks[-2], 1) if len(ticks) >= 2 else 1
    return tb[0], tb[1], ticks, ext


class TimecodeMap:
    """Frame-index -> pts-tick mapping with extrapolation past the file
    end (the reference extends at the assumed/last fps)."""

    def __init__(self, path: str, fallback_fps=(25, 1), timebase=None):
        self.tb_num, self.tb_den, self._ticks, self._ext = parse_tcfile(
            path, fallback_fps, timebase)

    def pts(self, idx: int) -> int:
        if idx < 0:
            # negative dts from B-frame delay: extend backwards at the
            # first interval so ctts offsets stay consistent
            first = (self._ticks[1] - self._ticks[0]
                     if len(self._ticks) > 1 else self._ext)
            return self._ticks[0] + idx * first
        if idx < len(self._ticks):
            return self._ticks[idx]
        over = idx - (len(self._ticks) - 1)
        return self._ticks[-1] + over * self._ext


class TimecodeWriter:
    """--tcfile-out: 'timecode format v2' file, one ms timestamp per
    frame in display order (x264.c:1663 writes %.6f ms)."""

    def __init__(self, path: str, tb_num: int, tb_den: int) -> None:
        self._f = open(path, "w")
        self._f.write("# timecode format v2\n")
        self._scale = 1000.0 * tb_num / tb_den
        self._pending: List[int] = []

    def add(self, pts: int) -> None:
        # collect; written sorted at close so coding-order B output
        # still yields a display-order tcfile
        self._pending.append(pts)

    def close(self) -> None:
        for p in sorted(self._pending):
            self._f.write(f"{p * self._scale:.6f}\n")
        self._f.close()
