"""The port's own tracing: spans and counters on the host, off by default.

    from x264_tpu_torch.utils import trace
    trace.start()
    ...                       # Encoder.encode calls
    rec = trace.stop()        # Records: spans, counters, clock pairs

`span(name, frame=None)` is a context manager and `@spanned(name)` a
decorator; both time a stretch of host work. Names are "<layer>:<stage>"
(encoder, lookahead, analysis, entropy; "sync:<site>" for the host waiting
on the device, see `waits`). `count(name, n)` adds to a counter of the
current frame.

Off (the default), each call tests one module global and returns: no
allocation, no clock read. On, a span records [name, start ns, end ns,
parent span's index or -1, frame] on `time.perf_counter_ns()`. The frame
is the input index of the frame the work is for: a span given `frame=`
sets it for itself and everything under it, other spans take their
parent's (None outside any frame). Counters are kept per (frame, name).
Nothing here synchronises with a device: a span ends when the host's work
ends, and the host's waits are the `sync:` spans of the sites that wait.

`start()` and `stop()` each read the Unix clock and the span clock
together (`clock`), so that device timestamps on the Unix clock (the
profiler's) can be mapped onto the spans' clock. One thread records: the
encoder's.
"""

from __future__ import annotations

import functools
import time

_rec = None      # the Records being filled, None when off


class Records:
    """What one start() ... stop() recorded. `spans`: [name, t0 ns, t1 ns,
    parent index or -1, frame] in start order; `counters`: {(frame, name):
    n}; `clock`: [(unix ns, perf_counter ns)] read at start and at stop."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.clock = [_clock_pair()]
        self.stack = []          # indices of the open spans


def _clock_pair():
    """(time.time_ns(), time.perf_counter_ns()) read together: of five
    tries the one with the least time between its two perf_counter reads,
    the Unix reading set against their midpoint."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u, (a + b) // 2)
    return best[1], best[2]


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "frame", "rec", "i")

    def __init__(self, rec, name, frame):
        self.rec, self.name, self.frame = rec, name, frame

    def __enter__(self):
        rec = self.rec
        st = rec.stack
        parent = st[-1] if st else -1
        frame = self.frame
        if frame is None and st:
            frame = rec.spans[parent][4]
        self.i = len(rec.spans)
        rec.spans.append([self.name, time.perf_counter_ns(), 0, parent,
                          frame])
        st.append(self.i)
        return None

    def __exit__(self, *exc):
        self.rec.spans[self.i][2] = time.perf_counter_ns()
        self.rec.stack.pop()
        return False


def span(name: str, frame=None):
    """A context manager timing its block as span `name`; `frame` sets the
    frame of the span and of everything under it."""
    if _rec is None:
        return _NULL
    return _Span(_rec, name, frame)


def spanned(name: str):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            if _rec is None:
                return fn(*args, **kw)
            with _Span(_rec, name, None):
                return fn(*args, **kw)
        return timed
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the current frame."""
    if _rec is None:
        return
    rec = _rec
    frame = rec.spans[rec.stack[-1]][4] if rec.stack else None
    key = (frame, name)
    rec.counters[key] = rec.counters.get(key, 0) + n


class _Wait(_Span):
    __slots__ = ()

    def __enter__(self):
        _Span.__enter__(self)
        rec = self.rec
        key = (rec.spans[self.i][4], "host_syncs")
        rec.counters[key] = rec.counters.get(key, 0) + 1
        return None


def waits(site: str):
    """A context manager around one operation for which the host waits for
    the device (a blocking copy to or from it, or an operation that reads
    its data): a span "sync:<site>" and one more `host_syncs` of the
    current frame."""
    if _rec is None:
        return _NULL
    return _Wait(_rec, "sync:" + site, None)


def current():
    """The name of the innermost open span, or None (also when off)."""
    if _rec is None or not _rec.stack:
        return None
    return _rec.spans[_rec.stack[-1]][0]


def start() -> None:
    """Turn recording on, into new Records."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace: already recording")
    _rec = Records()


def stop() -> Records:
    """Turn recording off and return what was recorded."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        raise RuntimeError("trace: not recording")
    rec.clock.append(_clock_pair())
    return rec
