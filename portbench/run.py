"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

One process, one CUDA card. Set-up: import, CUDA, the kernel library
(built once per checkout under x264_tpu_torch/_build/), the cell's clip
made on the card from the seed and copied to the host as numpy, an
`Encoder` of the cell's configuration, and the cell's W warm-up frames.
The window then feeds the clip to `Encoder.encode`, one `Picture` per
call, each call as soon as the last returned (closed loop, no flush),
until `--seconds` have passed; it ends when the call running at that
moment returns. After the window: the quality frames are Q consecutive
frames in display order from the first frame output in the window (any
of them not yet output is encoded now, untimed), the memory peak is
read, and the reference decoder
checks a sample of the window's frames (check.py). With --trace 1 the
window's first half also runs the spans of layers.json and, over its
first T output frames, torch.profiler and the capture of the kernels'
launches; its second half runs as an untraced window does.

The last line on stdout is the result as JSON; the numbers compared for
`correct`, each with its limit, are the last lines on stderr and the last
key of the result. Before them, `host` gives what the host did over the
window (this process's CPU time, preemptions, the machine's steal and
busy shares, the CPU stall share, the cores' clock), since the port is
bound by the host and fps follows its speed. The run
exits non-zero with no result line when there is no card (no fallback),
when the configuration is refused, when a module of jax or x264_tpu is
loaded, or when a child process or a non-daemon thread is left.

--device cpu and --manifest / --data are for the CPU rehearsal in
portbench/tests only: such a run reports platform "cpu".
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
BANNED = ("jax", "jaxlib", "flax", "x264_tpu")
TYPE_NAMES = {1: "I", 2: "I", 3: "P", 4: "B", 5: "B"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """The reader of metric `name`: portbench/metrics/<name>.py `read`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_of(manifest: dict, data: str, workload: str):
    """(cell entry, configuration file, traffic mix, cell file) of
    `workload`, found by name."""
    cells = [w for w in manifest["workloads"] if w["name"] == workload]
    if not cells:
        raise SystemExit(f"no workload {workload!r} in the manifest")
    cell = cells[0]
    cfg = [c for c in manifest["configs"] if c["name"] == cell["config"]][0]
    config = load_json(os.path.join(ROOT, cfg["file"]))
    mix = load_json(os.path.join(data, "traffic", cell["traffic"] + ".json"))
    sizes = load_json(os.path.join(data, "cells", workload + ".json"))
    return cell, config, mix, sizes


def make_params(config: dict):
    """x264_tpu_torch Params of a configuration file: the preset and tune,
    then each option as x264's command line names it."""
    from x264_tpu_torch.params import param_default_preset, param_parse
    p = param_default_preset(config.get("preset") or None,
                             config.get("tune") or None)
    for name, value in config.get("options", {}).items():
        param_parse(p, name, str(value))
    p.width, p.height = config["width"], config["height"]
    return p


def full_planes(torch, recon, mbw, mbh):
    """The uncropped planes of a PicOut's recon (views of the padded
    planes the encoder reconstructed), cloned where they are."""
    out = []
    for i, r in enumerate(recon):
        h, w = (mbh * 16, mbw * 16) if i == 0 else (mbh * 8, mbw * 8)
        if not isinstance(r, torch.Tensor):
            raise TypeError("recon planes are not tensors")
        out.append(r.as_strided((h, w), r.stride(),
                                r.storage_offset()).clone())
    return out


def live_children():
    """[(pid, command)] of this process's children, from /proc."""
    me, found = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if int(fields[1]) == me:
            found.append((int(d), stat[stat.find("(") + 1:stat.rfind(")")]))
    return found


def host_counters() -> dict:
    """The host's counters now: this process's CPU seconds (every thread)
    and its main thread's involuntary context switches, the machine's CPU
    ticks by kind (/proc/stat) and its CPU-pressure stall microseconds
    (/proc/pressure/cpu); a counter the kernel does not offer is left
    out."""
    c = {"t": time.perf_counter(), "cpu_s": time.process_time()}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    c["preempted"] = int(line.split()[1])
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
        c["ticks"] = ticks           # user nice system idle iowait irq
    except (OSError, ValueError):    # softirq steal
        pass
    try:
        with open("/proc/pressure/cpu") as f:
            c["stall_us"] = int(f.readline().rsplit("total=", 1)[1])
    except (OSError, ValueError, IndexError):
        pass
    return c


def host_over(a: dict, b: dict, frames: int) -> dict:
    """What the host did between two readings of host_counters: this
    process's CPU seconds per second of wall time and per frame, how
    often it was preempted, the machine's steal and busy shares, the CPU
    stall share, the mean clock of its cores and the load average."""
    dt = max(b["t"] - a["t"], 1e-9)
    out = {"cpus": len(os.sched_getaffinity(0)),
           "cpu_s_per_s": (b["cpu_s"] - a["cpu_s"]) / dt,
           "cpu_ms_per_frame": 1e3 * (b["cpu_s"] - a["cpu_s"])
           / max(frames, 1)}
    if "preempted" in a and "preempted" in b:
        out["preempted_per_s"] = (b["preempted"] - a["preempted"]) / dt
    if "ticks" in a and "ticks" in b:
        d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
        total = max(sum(d), 1)
        out["steal_pct"] = 100.0 * d[7] / total
        out["iowait_pct"] = 100.0 * d[4] / total
        out["machine_busy_pct"] = 100.0 * (total - d[3] - d[4] - d[7]) / total
    if "stall_us" in a and "stall_us" in b:
        out["cpu_stall_pct"] = (b["stall_us"] - a["stall_us"]) / dt / 1e4
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        if mhz:
            out["mhz_mean"] = sum(mhz) / len(mhz)
        out["loadavg_1"] = os.getloadavg()[0]
    except (OSError, ValueError):
        pass
    return out


def reap_children() -> list:
    """Kill and reap every live child; returns what was found."""
    found = live_children()
    for pid, _ in found:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return found


def run(args) -> int:
    import numpy as np
    import torch
    manifest = load_json(args.manifest)
    cell, config, mix, sizes = cell_of(manifest, args.data, args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA card: torch.cuda.is_available() is false")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log(f"the cell asks for {cell['chips']} cards, "
                f"{torch.cuda.device_count()} found")
            return 2
        torch.cuda.set_device(dev.index or 0)
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    sys.path.insert(0, ROOT)
    from x264_tpu_torch.encoder.encoder import Encoder, Picture
    from portbench import check, clipgen, spans as spans_mod
    from portbench.devtrace import Capture, DeviceTrace

    marks = [("imports", time.perf_counter())]
    p = make_params(config)
    enc = Encoder(p, device=dev)
    headers = [n.payload for n in enc.headers()]
    mbw, mbh = p.mb_width, p.mb_height
    clip = clipgen.make_clip(mix, p.width, p.height, args.seed, dev)
    marks.append(("clip", time.perf_counter()))
    W, Q = int(sizes["warmup_frames"]), int(sizes["quality_frames"])
    coded = []              # every frame output, in coding order
    t_call = {}             # pts -> host time its encode call started
    state = {"pushed": 0}

    def encode_next():
        i = state["pushed"]
        pic = Picture(clip[i % len(clip)], pts=i)
        t0 = time.perf_counter()
        nals, out = enc.encode(pic)
        t1 = time.perf_counter()
        t_call[i] = t0
        state["pushed"] += 1
        if out is not None:
            coded.append({
                "pts": out.pts, "type": TYPE_NAMES.get(out.i_type, "?"),
                "qp": out.qp, "nals": [n.payload for n in nals],
                "nbytes": sum(4 + len(n.payload) for n in nals),
                "t_in": t_call[out.pts], "t_out": t1,
                "recon": full_planes(torch, out.recon, mbw, mbh)})
        return t1

    for _ in range(W):
        encode_next()
    sync()
    marks.append(("warm-up", time.perf_counter()))
    trace = spans = capture = None
    if args.trace:
        spans = spans_mod.Spans(sync)
        if dev.type == "cuda":
            capture = Capture()
            trace = DeviceTrace(torch, dev, spans)
    first = len(coded)
    log("window: start")
    host_start = host_counters()
    t_start = time.perf_counter()
    setup_s = t_start - T_PROCESS
    deadline = t_start + args.seconds
    t_end = t_start
    # a traced window: the first T output frames under the profiler and
    # the spans, the spans alone until half-time, then nothing, so that
    # the latency tail is read on calls that no span synchronises
    t_clean = t_start
    if spans is not None:
        with spans:
            if trace is not None:
                with trace, capture:
                    while len(coded) - first < int(sizes["trace_frames"]):
                        t_end = encode_next()
            while t_end < t_start + args.seconds / 2:
                t_end = encode_next()
        t_clean = time.perf_counter()
    n_spanned = len(coded) - first
    while t_end < deadline:
        t_end = encode_next()
    sync()
    window_s = t_end - t_start
    n_window = len(coded) - first
    host = host_over(host_start, host_counters(), n_window)
    pushed_window = state["pushed"] - W
    # the quality frames: Q consecutive frames in display order from the
    # first one output in the window, whatever the speed; those not yet
    # output are encoded now, untimed
    p0 = coded[first]["pts"] if n_window else state["pushed"]
    while sum(p0 <= f["pts"] < p0 + Q for f in coded) < Q:
        encode_next()
    sync()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    lost = state["pushed"] - len(coded) - enc.delayed_frames()
    del enc

    quality = [f for f in coded if p0 <= f["pts"] < p0 + Q]
    sse = 0.0
    for fr in quality:
        src = clip[fr["pts"] % len(clip)][0].astype(np.int64)
        rec = fr["recon"][0][:p.height, :p.width].cpu().numpy()
        sse += float(((rec.astype(np.int64) - src) ** 2).sum())
    fps_declared = p.fps_num / max(1, p.fps_den)
    result_run = {
        "setup_s": setup_s,
        "window_s": window_s, "frames": coded[first:first + n_window],
        "quality": {"frames": Q,
                    "bytes": sum(f["nbytes"] for f in quality),
                    "fps_declared": fps_declared, "sse_y": sse,
                    "pixels_y": Q * p.width * p.height},
        "spans": spans, "trace": None,
        "spanned_frames": n_spanned, "clean_from": t_clean}
    if trace is not None:
        result_run["trace"] = trace.read(capture.calls)

    # the comparison, after the window and with the encoder freed
    t_check = time.perf_counter()
    verdict = check.compare(headers, coded, first, first + n_window,
                            [coded.index(f) for f in quality], args.seed,
                            int(sizes["check_frames"]), lost)
    t_check = time.perf_counter() - t_check
    for rec in coded:
        rec["recon"] = None

    want = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest[want]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = load_reader(m["name"])(result_run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    result = {"correct": verdict["correct"], "attempted": pushed_window,
              "failed": verdict["failed"], "metrics": metrics,
              "device": device}
    if result_run["trace"] is not None:
        tr = result_run["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["host"] = host
    result["check"] = verdict["numbers"]

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        log(f"modules that the benchmark may not load are loaded: {loaded}")
        return 3
    left = reap_children()
    if left:
        log(f"child processes were left running and are killed: {left}")
        return 3
    others = [t.name for t in threading.enumerate()
              if t is not threading.main_thread() and not t.daemon
              and t.is_alive()]
    if others:
        log(f"non-daemon threads are left running: {others}")
        return 3
    log(f"frames: {n_window} in the window of {window_s:.3f} s "
        f"({''.join(f['type'] for f in result_run['frames'])}), "
        f"{pushed_window} pushed; set-up {setup_s:.3f} s; decoded "
        f"{verdict['decoded']} in {t_check:.1f} s; set-up marks "
        + ", ".join(f"{n} {t - T_PROCESS:.2f}" for n, t in marks))
    log("host over the window: " + ", ".join(
        f"{k} {v:.6g}" for k, v in host.items()))
    for err in verdict["errors"]:
        log(f"check: the reference could not decode {err}")
    for name, v in verdict["numbers"].items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--manifest", default=os.path.join(ROOT,
                                                       "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--data", default=HERE, help=argparse.SUPPRESS)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
