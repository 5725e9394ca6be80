"""The program's own spans in a traced run: the port's tracer
(x264_tpu_torch/utils/trace.py), unsynchronised, read beside the device
trace on one clock.

After a traced run's window, the first reader of a metric below calls
`stretch(run)` (once per run; later calls return the same readings). It
makes a new `Encoder` of the run's configuration on the run's clip and
device, feeds it the cell's W warm-up frames, then the next pictures, one
call at a time, until T (the cell's trace_frames) frames have come out
with the port's tracer on; on a card, then T more with the tracer on and
`DeviceTrace` (torch.profiler) over the same calls. The profiler's
per-launch work slows the host (the two parts' encode ms per frame show
by how much), so the host readings come from the first part and the
device readings from the second. No wrapper of spans.py is active and
nothing synchronises beyond what the program itself does.

Readings, per frame output (host: first part; idle: second part):
  - a layer's host ms: the self time of its spans (a span's time less that
    of its child spans) over the `encoder:encode` spans, layer = the part
    of the span's name before the colon (encoder, lookahead, analysis,
    entropy); `sync:` spans are children, so a layer's host time leaves
    out its waits;
  - sync wait ms: the total of the `sync:` spans, the host blocked on the
    card (a blocking copy or a read of its data);
  - host syncs: the `host_syncs` counter;
  - idle in port: the share of the `encoder:encode` spans' time in which
    no operation ran on the card, the device's times mapped onto the
    spans' clock (`clock_map`).
It also prints to stderr the stretch's idle ms per frame by the innermost
program span the host was in.

The stretch needs the run's clip, parameters and device, which the
harness does not hand a reader: they are taken from the locals of
portbench/run.py's `run` frame, the reader's caller. Where the program
has no tracer (a checkout before it), `stretch` returns None and reads
nothing.

    python3 -m portbench.progtrace --workload <cell> --seed <n> --sync-debug

runs the same stretch under `torch.cuda.set_sync_debug_mode("warn")` and
prints, as JSON, the count of synchronising-operation warnings beside the
`host_syncs` counter, and where they differ, the sites (a card only).

    python3 -m portbench.progtrace --workload <cell> --seed <n> --tracer-cost S

times the cell's encode calls for S seconds after its warm-up in blocks of
frames with the tracer off, on, on, off, ... (no profiler), and prints
the fps of each side as JSON: what the tracer costs when on.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import time
import warnings

from portbench.devtrace import DeviceTrace

LAYERS = ("encoder", "lookahead", "analysis", "entropy")
SYNC_WARNING = "called a synchronizing CUDA operation"
_READINGS = {}


def available() -> bool:
    """Whether the program has its tracer."""
    try:
        return importlib.util.find_spec(
            "x264_tpu_torch.utils.trace") is not None
    except ImportError:
        return False


def clock_map(clock):
    """ns on the Unix clock -> s on the spans' clock (perf_counter), the
    line through the two (unix ns, perf_counter ns) pairs the tracer read
    at its start and its stop."""
    (u0, p0), (u1, p1) = clock[0], clock[-1]
    slope = (p1 - p0) / (u1 - u0) if u1 != u0 else 1.0
    return lambda unix_ns: (p0 + (unix_ns - u0) * slope) / 1e9


class ProgramSpans:
    """The tracer's spans as spans.py's `Spans` offers them to
    DeviceTrace: `host_span_at(t)`, the innermost span the host was in at
    time t (s, perf_counter), or "outside the port"."""

    def __init__(self, spans):
        edges = []                       # (t ns, 1 open / 0 close, index)
        for i, s in enumerate(spans):
            edges.append((s[1], 1, i))
            edges.append((s[2], 0, i))
        edges.sort(key=lambda e: (e[0], e[1]))
        self.times, self.names = [], []
        stack = []
        for t, opens, i in edges:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            self.times.append(t / 1e9)
            self.names.append(spans[stack[-1]][0] if stack
                              else "outside the port")

    def host_span_at(self, t: float) -> str:
        k = bisect.bisect_right(self.times, t) - 1
        return self.names[k] if k >= 0 else "outside the port"


class ProgramDeviceTrace(DeviceTrace):
    """DeviceTrace with the device's operations on the program's clock:
    each CUPTI timestamp (Unix ns) mapped by `clock_map` instead of the
    first operation being set at the host's start. `attach(records)` once
    the tracer has stopped, then `read` as DeviceTrace's."""

    def __init__(self, torch, device):
        super().__init__(torch, device, None)
        self.to_host_clock = self._ev = None

    def attach(self, records):
        self.spans = ProgramSpans(records.spans)
        self.to_host_clock = clock_map(records.clock)

    def events(self):
        if self._ev is None:
            DT = self.torch.autograd.DeviceType
            f = self.to_host_clock
            self._ev = sorted(
                ((e.name(), f(e.start_ns()),
                  f(e.start_ns() + e.duration_ns()))
                 for e in self.prof.profiler.kineto_results.events()
                 if e.device_type() == DT.CUDA), key=lambda r: r[1])
        return self._ev


def self_ns(spans):
    """{name: self ns} over spans whose root is an `encoder:encode` span,
    and the roots' total ns."""
    root = []
    for s in spans:
        root.append(root[s[3]] if s[3] >= 0 else s[0])
    child = [0] * len(spans)
    for s in spans:
        if s[3] >= 0:
            child[s[3]] += s[2] - s[1]
    out, total = {}, 0
    for i, s in enumerate(spans):
        if root[i] != "encoder:encode":
            continue
        if s[3] < 0:
            total += s[2] - s[1]
        out[s[0]] = out.get(s[0], 0) + (s[2] - s[1]) - child[i]
    return out, total


def busy_within(windows, ops):
    """Seconds of the union of the intervals `ops` that fall inside the
    union of the intervals `windows` (both [(start, end)] in s)."""
    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    w, o = union(windows), union(ops)
    busy, j = 0.0, 0
    for a, b in w:
        while j < len(o) and o[j][1] <= a:
            j += 1
        k = j
        while k < len(o) and o[k][0] < b:
            busy += max(0.0, min(b, o[k][1]) - max(a, o[k][0]))
            k += 1
    return busy


def readings(rec, frames, dev_rec=None, dtrace=None):
    """The stretch's readings (module doc) from the tracer's Records of
    its first part and the count of frames output in each part, and of
    its profiled part with the stopped ProgramDeviceTrace (None without a
    card)."""
    own, total = self_ns(rec.spans)
    layer = {k: 0 for k in LAYERS + ("sync",)}
    for name, ns in own.items():
        key = name.split(":", 1)[0]
        layer[key] = layer.get(key, 0) + ns
    out = {"frames": frames,
           "encode_ms_per_frame": total / 1e6 / frames,
           "host_ms_per_frame": {k: v / 1e6 / frames
                                 for k, v in layer.items() if k != "sync"},
           "sync_wait_ms_per_frame": layer["sync"] / 1e6 / frames,
           "host_syncs_per_frame": sum(
               n for (_, name), n in rec.counters.items()
               if name == "host_syncs") / frames,
           "idle_in_port_pct": None, "idle_ms_per_frame": None}
    if dtrace is not None:
        dtrace.attach(dev_rec)
        encode = [(s[1] / 1e9, s[2] / 1e9) for s in dev_rec.spans
                  if s[0] == "encoder:encode"]
        ops = [(s, e) for _, s, e in dtrace.events()]
        span_s = sum(b - a for a, b in encode)
        out["profiled_encode_ms_per_frame"] = 1e3 * span_s / frames
        if ops and span_s > 0:
            out["idle_in_port_pct"] = 100.0 * (
                1 - busy_within(encode, ops) / span_s)
        tr = dtrace.read([])
        out["idle_ms_per_frame"] = [[n, 1e3 * v / frames]
                                    for n, v in tr["idle_gaps"]]
        out["device_window_s"], out["device_busy_s"] = (tr["window_s"],
                                                        tr["busy_s"])
    return out


def _harness():
    """The locals of portbench/run.py's `run` frame up the stack."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if (code.co_name == "run"
                and code.co_filename.endswith(os.path.join("portbench",
                                                           "run.py"))):
            return f.f_locals
        f = f.f_back
    return None


def _feeder(h):
    """A function that feeds a new Encoder of the run's configuration the
    clip's next picture, one encode call, and says whether a frame came
    out."""
    enc = h["Encoder"](h["p"], device=h["dev"])
    clip, state = h["clip"], {"pushed": 0}

    def encode_next():
        i = state["pushed"]
        _, out = enc.encode(h["Picture"](clip[i % len(clip)], pts=i))
        state["pushed"] += 1
        return out is not None
    return encode_next


def _traced(encode_next, frames):
    """Encode until `frames` frames have come out, with the port's tracer
    on; its Records."""
    from x264_tpu_torch.utils import trace
    n = 0
    trace.start()
    try:
        while n < frames:
            n += encode_next()
    finally:
        rec = trace.stop()
    return rec


def _warm(h):
    """A fed new Encoder (`_feeder`) past the cell's W warm-up frames."""
    encode_next = _feeder(h)
    for _ in range(int(h["sizes"]["warmup_frames"])):
        encode_next()
    if h["dev"].type == "cuda":
        h["torch"].cuda.synchronize(h["dev"])
    return encode_next


def run_stretch(h):
    """The stretch of the module doc on the harness's locals `h` (clip,
    p, dev, sizes, torch, Encoder, Picture). Returns (Records of the first
    part, T, Records of the profiled part and the ProgramDeviceTrace, or
    None and None without a card)."""
    T = int(h["sizes"]["trace_frames"])
    encode_next = _warm(h)
    rec = _traced(encode_next, T)
    if h["dev"].type != "cuda":
        return rec, T, None, None
    with ProgramDeviceTrace(h["torch"], h["dev"]) as dtrace:
        dev_rec = _traced(encode_next, T)
    return rec, T, dev_rec, dtrace


def sync_debug_stretch(h, from_start=False):
    """The stretch's first part under torch's sync debug mode (module
    doc); with from_start, from the first frame, the W warm-up frames
    counted too. Returns (Records, frames, [(inside a sync: span, site)]
    of the synchronising operations torch warned of)."""
    from x264_tpu_torch.utils import trace
    torch = h["torch"]
    T = int(h["sizes"]["trace_frames"])
    if from_start:
        encode_next = _feeder(h)
        T += int(h["sizes"]["warmup_frames"])
    else:
        encode_next = _warm(h)
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            seen.append((str(trace.current()).startswith("sync:"),
                         _port_site()))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rec = _traced(encode_next, T)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return rec, T, seen


def _port_site():
    """file:line of the innermost frame of x264_tpu_torch on the stack."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if os.sep + "x264_tpu_torch" + os.sep in fn:
            return (f"{fn.split(os.sep + 'x264_tpu_torch' + os.sep)[1]}:"
                    f"{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return "outside the port"


def stretch(run):
    """The readings of the program's stretch in this traced run, made at
    the first call (module doc); None where the program has no tracer or
    the harness's state is not found."""
    if "readings" in _READINGS:
        return _READINGS["readings"]
    _READINGS["readings"] = None
    if not available():
        return None
    h = _harness()
    if h is None or not h["args"].trace:
        return None
    t0 = time.perf_counter()
    r = readings(*run_stretch(h))
    _READINGS["readings"] = r
    parts = ", ".join(f"{k} {v:.3f}"
                      for k, v in r["host_ms_per_frame"].items())
    print(f"program stretch: {r['frames']} frames in "
          f"{time.perf_counter() - t0:.1f} s; encode "
          f"{r['encode_ms_per_frame']:.3f} ms/frame = host {parts}, sync "
          f"{r['sync_wait_ms_per_frame']:.3f}; host syncs "
          f"{r['host_syncs_per_frame']:.2f}/frame; under the profiler "
          f"encode {r.get('profiled_encode_ms_per_frame')} ms/frame, idle "
          f"in port {r['idle_in_port_pct']}%", file=sys.stderr, flush=True)
    if r["idle_ms_per_frame"] is not None:
        print("program stretch: idle ms per frame by innermost span: "
              + ", ".join(f"{n} {v:.3f}" for n, v in r["idle_ms_per_frame"]),
              file=sys.stderr, flush=True)
    return r


def tracer_cost(h, seconds, block=6):
    """fps with the tracer off and on, in alternating blocks of `block`
    output frames over `seconds` after the warm-up (module doc)."""
    from x264_tpu_torch.utils import trace
    torch, dev = h["torch"], h["dev"]
    encode_next = _warm(h)
    blocks = {"off": [], "on": []}
    order = ("off", "on", "on", "off")
    t_end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < t_end:
        side = order[k % 4]
        k += 1
        if side == "on":
            trace.start()
        t0, n = time.perf_counter(), 0
        while n < block:
            n += encode_next()
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if side == "on":
            trace.stop()
        blocks[side].append(n / dt)
    return {side: {"fps_blocks": v, "fps_median": sorted(v)[len(v) // 2]}
            for side, v in blocks.items()}


def main(argv=None) -> int:
    """The completeness check and the tracer's cost (module doc), on the
    card."""
    import argparse
    ap = argparse.ArgumentParser(description="the program's tracer on the "
                                 "card: sync-debug count or cost")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--sync-debug", action="store_true")
    mode.add_argument("--tracer-cost", type=float, metavar="SECONDS")
    ap.add_argument("--from-start", action="store_true")
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--data", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import clipgen
    from portbench import run as harness
    from x264_tpu_torch.encoder.encoder import Encoder, Picture
    manifest = harness.load_json(args.manifest or os.path.join(
        harness.ROOT, "BENCHMARK.json"))
    _, config, mix, sizes = harness.cell_of(manifest, args.data or
                                            harness.HERE, args.workload)
    dev = torch.device("cuda")
    p = harness.make_params(config)
    clip = clipgen.make_clip(mix, p.width, p.height, args.seed, dev)
    h = {"torch": torch, "dev": dev, "clip": clip, "p": p, "sizes": sizes,
         "Encoder": Encoder, "Picture": Picture}
    card = torch.cuda.get_device_name(dev)
    if args.tracer_cost:
        print(json.dumps({"workload": args.workload, "device": card,
                          **tracer_cost(h, args.tracer_cost)}), flush=True)
        return 0
    rec, frames, seen = sync_debug_stretch(h, from_start=args.from_start)
    syncs = sum(n for (_, name), n in rec.counters.items()
                if name == "host_syncs")
    missed, counted = {}, {}
    for inside, site in seen:
        d = counted if inside else missed
        d[site] = d.get(site, 0) + 1
    by_span = {}
    for s in rec.spans:
        if s[0].startswith("sync:"):
            by_span[s[0]] = by_span.get(s[0], 0) + 1
    print(json.dumps({
        "workload": args.workload, "frames": frames,
        "from_start": args.from_start, "warnings": len(seen),
        "host_syncs": syncs, "equal": len(seen) == syncs,
        "warnings_outside_sync_spans": missed,
        "warnings_inside_sync_spans": counted,
        "sync_spans": by_span, "device": card}), flush=True)
    return 0 if len(seen) == syncs else 1


if __name__ == "__main__":
    sys.exit(main())
