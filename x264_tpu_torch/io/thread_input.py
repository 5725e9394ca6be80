"""Async read-ahead input wrapper (reference: input/thread.c:142).

Wraps any demuxer/filter stage with a producer thread and a bounded
queue, so disk/pipe reads of frame k+1..k+depth overlap the encode of
frame k — the reference's "input pipeline thread" stage (SURVEY §2.9.5).
"""

from __future__ import annotations

import queue
import threading


class ThreadedReader:
    """Producer-thread wrapper over a frame iterator with `info`."""

    _SENTINEL = object()

    def __init__(self, reader, depth: int = 4) -> None:
        self._reader = reader
        self.info = reader.info
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._exc: BaseException | None = None
        self._stop = threading.Event()
        # lazy start: spawning the producer before the consumer's device
        # runtime initializes can deadlock client setup, so the thread
        # starts on first iteration
        self._t: threading.Thread | None = None

    def _produce(self) -> None:
        try:
            for planes in self._reader:
                if self._stop.is_set():
                    return
                self._q.put(planes)
        except BaseException as e:          # surfaced on the consumer side
            self._exc = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        if self._t is None:
            self._t = threading.Thread(target=self._produce, daemon=True)
            self._t.start()
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        # unblock the producer if it is waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._t is not None:
            self._t.join(timeout=5)
        self._reader.close()
