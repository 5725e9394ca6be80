"""Spans around the calls into the port's layers, taken by the benchmark's
own wrappers (a traced run only).

`layers.json` lists, for each layer, the functions that enter it:
[module, attribute, stage], where the attribute is a module-level name
looked up at call time (`Class.method` for a method). Inside the `with`
block each is wrapped, as chip_smoke.py's StageTimer does: the device is
synchronised before and after every call, and the call's host-clock time
less that of the wrapped calls it makes goes to its stage (self time).
Every span is also kept as (start, end, "layer:stage", depth) so that a
device idle gap can be named after what the host was doing.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_hooks(path=os.path.join(HERE, "layers.json")):
    """[(module, attribute, layer, stage)] from layers.json."""
    with open(path) as f:
        layers = json.load(f)["layers"]
    return [(mod, attr, layer, stage)
            for layer, spec in layers.items()
            for mod, attr, stage in spec["hooks"]]


class Spans:
    """Wraps the hooked functions while active; see the module doc."""

    def __init__(self, sync, hooks=None):
        self.sync = sync
        self.ms = {}            # "layer:stage" -> self ms
        self.calls = {}
        self.timeline = []      # (t0, t1, "layer:stage", depth)
        self._inner = []
        self._hooks = []
        for mod, attr, layer, stage in hooks or load_hooks():
            obj = importlib.import_module(mod)
            *owner, name = attr.split(".")
            for part in owner:
                obj = getattr(obj, part)
            self._hooks.append((obj, name, f"{layer}:{stage}"))

    def layer_ms(self, layer: str) -> float:
        return sum(v for k, v in self.ms.items()
                   if k.split(":", 1)[0] == layer)

    def _wrap(self, fn, key):
        @functools.wraps(fn)        # keeps attributes such as counters
        def timed(*args, **kw):
            self.sync()
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                self.sync()
            finally:
                inner = self._inner.pop()
            t1 = time.perf_counter()
            dt = (t1 - t0) * 1e3
            self.ms[key] = self.ms.get(key, 0.0) + dt - inner
            self.calls[key] = self.calls.get(key, 0) + 1
            self.timeline.append((t0, t1, key, len(self._inner)))
            if self._inner:
                self._inner[-1] += dt
            return out
        return timed

    def __enter__(self):
        # an attribute not in the object's own dict (an inherited method)
        # is deleted again on exit, the others are put back
        self._saved = [(obj, name, vars(obj).get(name))
                       for obj, name, _ in self._hooks]
        for obj, name, key in self._hooks:
            setattr(obj, name, self._wrap(getattr(obj, name), key))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            wrapped = vars(obj).get(name)
            if fn is not None and wrapped is not None:
                fn.__dict__.update({k: v for k, v in wrapped.__dict__.items()
                                    if k != "__wrapped__"})
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
        return False

    def host_span_at(self, t: float) -> str:
        """The innermost span the host was in at host time t, or
        "outside the port" when none."""
        best, depth = "outside the port", -1
        for t0, t1, key, d in self.timeline:
            if t0 <= t <= t1 and d > depth:
                best, depth = key, d
        return best
