"""The traced run's device readings, from torch.profiler (CUPTI).

`DeviceTrace` profiles the CUDA activity of a stretch of the window (the
cell's first T output frames). On exit it has every operation that ran
on the card; `read` turns them into the device's busy seconds (the union
of the operations' intervals) and the traced window's length, the ten
operations that took most time, the idle time by what the host was
doing (the span of spans.py the host was in at each gap's middle), and
each launch of the port's kernels with its device time beside its bound
(roofline.py).

`Capture` records the launches of the port's kernel wrappers over the
same stretch: their arguments give each launch's bound.

The profiler inflates host time, so the idle share it gives is an upper
bound on the untraced run's.
"""

from __future__ import annotations

import functools
import time

from portbench import roofline

MARK = 4096     # bytes of the fill that marks the start on the device


class DeviceTrace:
    def __init__(self, torch, device, spans):
        self.torch, self.device, self.spans = torch, device, spans

    def __enter__(self):
        torch = self.torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        # the first operation of the trace: its start is t0 on the device
        torch.empty(MARK, dtype=torch.uint8, device=self.device).fill_(90)
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """[(name, start s, end s)] of the device's operations, on the
        host's perf_counter clock."""
        DT = self.torch.autograd.DeviceType
        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DT.CUDA]
        if not raw:
            return []
        raw.sort(key=lambda r: r[1])
        base = raw[0][1]
        return [(n, self.t0 + (s - base) / 1e9, self.t0 + (e - base) / 1e9)
                for n, s, e in raw]

    def read(self, calls):
        """The traced window's readings; `calls` are Capture's launches."""
        ev = self.events()
        window_s = self.t1 - self.t0
        busy, gaps, cur = 0.0, [], None
        for _, s, e in ev:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                gaps.append(((cur[1] if cur else self.t0), s))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], self.t1))
        idle = {}
        for g0, g1 in gaps:
            if g1 > g0:
                name = self.spans.host_span_at((g0 + g1) / 2)
                idle[name] = idle.get(name, 0.0) + (g1 - g0)
        ops = {}
        for n, s, e in ev:
            ops[n] = ops.get(n, 0.0) + (e - s)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window_s,
                "device_ops": [[n[:160], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps_top],
                "launches": self.launches(ev, calls),
                "n_ops": len(ev)}

    def launches(self, ev, calls):
        """[(wrapper, device s, bound s or None)] of each captured launch,
        matched in order to the device's kernels of its name; None when
        the two sequences do not line up."""
        names = set(roofline.KERNEL_OF.values())
        kernels = [(n, e - s) for n, s, e in ev
                   if any(k in n for k in names)]
        if len(kernels) != len(calls):
            return None
        rate = roofline.rates(self.torch.cuda.get_device_name(self.device))
        out = []
        for (kname, dev_s), (wrapper, a, o) in zip(kernels, calls):
            if roofline.KERNEL_OF[wrapper] not in kname:
                return None
            b = (roofline.bound_ms(wrapper, a, o, rate) / 1e3
                 if rate is not None else None)
            out.append((wrapper, dev_s, b))
        return out


class Capture:
    """Records each launch of the port's kernel wrappers (ops/commit.py,
    ops/deblock.py, ops/motion.py) while active: the wrapper, its bound
    arguments and its output, kept light (roofline.light)."""

    def __init__(self):
        import inspect
        from x264_tpu_torch.ops import commit, deblock, motion
        self.calls = []
        self._hooks = [(mod, name, inspect.signature(getattr(mod, name)))
                       for mod, names in ((commit, ["commit_launch"]),
                                          (deblock, ["deblock_launch"]),
                                          (motion, ["lowres_scan_launch",
                                                    "refine_launch",
                                                    "esa_launch",
                                                    "subpel_launch"]))
                       for name in names]

    def _wrap(self, fn, name, sig):
        light = roofline.light

        @functools.wraps(fn)        # keeps the wrapper's launch counter
        def launched(*args, **kw):
            out = fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            self.calls.append((name, light(dict(bound.arguments)),
                               light(out)))
            return out
        return launched

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name, _ in self._hooks]
        for mod, name, sig in self._hooks:
            setattr(mod, name, self._wrap(getattr(mod, name), name, sig))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            fn.__dict__.update({k: v for k, v in
                                getattr(mod, name).__dict__.items()
                                if k != "__wrapped__"})
            setattr(mod, name, fn)
        return False
