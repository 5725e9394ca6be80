"""The program's own spans in the benchmark (portbench/progtrace.py):
the CPU rehearsal of a traced run prints the metrics that read them, the
span lookup and the busy time are right on planted timelines, and on a
card the device trace and the spans share one clock (a planted idle gap
is put down to the span it happened in, to the half millisecond) and
torch's sync debug mode counts as many synchronising operations as the
program's `host_syncs` counter."""

import json
import os
import re
import sys
import time

import pytest

from test_portbench_processes import finish, last_line, start

HERE = os.path.dirname(os.path.abspath(__file__))
REHEARSAL = os.path.join(HERE, "rehearsal")
MANIFEST = os.path.join(REHEARSAL, "bench_progtrace.json")
HOST = ["encoder_host_ms_per_frame", "lookahead_host_ms_per_frame",
        "analysis_host_ms_per_frame", "entropy_host_ms_per_frame",
        "sync_wait_ms_per_frame"]
STRETCH = re.compile(r"program stretch: \d+ frames in [\d.]+ s; encode "
                     r"([\d.]+) ms/frame")


def traced(workload, device="cpu"):
    return ["portbench/run.py", "--workload", workload, "--seed",
            "3141592653", "--seconds", "2", "--trace", "1", "--device",
            device, "--manifest", MANIFEST, "--data", REHEARSAL]


@pytest.mark.parametrize("workload", ["tiny_medium.tiny", "tiny_live.tiny"])
def test_traced_rehearsal_prints_the_program_metrics(workload):
    rc, out, err = finish(start(traced(workload)))
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in HOST + ["host_syncs_per_frame"]:
        assert name in m and m[name] >= 0, name
    assert m["host_syncs_per_frame"] > 0
    assert "idle_in_port_pct" not in m        # no card, no device trace
    # the layers' host time and the waits make up the encode calls (the
    # stderr line rounds to the microsecond)
    encode = float(STRETCH.search(err).group(1))
    assert sum(m[k] for k in HOST) == pytest.approx(encode, abs=1e-3)


def test_host_span_at_names_the_innermost_span():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from portbench.progtrace import ProgramSpans
    s = ProgramSpans([["encoder:encode", 1_000, 9_000, -1, 0],
                      ["analysis:rd", 2_000, 5_000, 0, 0],
                      ["sync:satd", 3_000, 4_000, 1, 0],
                      ["entropy:cavlc", 6_000, 7_000, 0, 0]])
    at = {t: s.host_span_at(t * 1e-9) for t in
          (500, 1_500, 2_500, 3_500, 4_500, 5_500, 6_500, 8_000, 9_500)}
    assert at == {500: "outside the port", 1_500: "encoder:encode",
                  2_500: "analysis:rd", 3_500: "sync:satd",
                  4_500: "analysis:rd", 5_500: "encoder:encode",
                  6_500: "entropy:cavlc", 8_000: "encoder:encode",
                  9_500: "outside the port"}


def test_busy_within_counts_only_inside_the_windows():
    from portbench.progtrace import busy_within
    windows = [(0.0, 1.0), (2.0, 3.0)]
    ops = [(-0.5, 0.25), (0.5, 0.75), (0.7, 2.5), (2.9, 4.0)]
    assert busy_within(windows, ops) == pytest.approx(
        0.25 + 0.5 + 0.5 + 0.1)


@pytest.mark.cuda
def test_planted_gap_is_put_down_to_its_span(cuda_card):
    """A kernel, 20 ms of host work, a kernel, all inside the span
    `test:gap`: the device trace on the program's clock finds an idle gap
    of 20 +- 0.5 ms there, and each kernel within 0.5 ms of its launch.
    The host spins on its clock (a sleep may oversleep by a millisecond
    on a loaded host)."""
    import torch
    from portbench.progtrace import ProgramDeviceTrace
    from x264_tpu_torch.utils import trace
    x = torch.zeros(1024, device=cuda_card)
    x.add_(1)
    torch.cuda.synchronize()
    dt = ProgramDeviceTrace(torch, cuda_card)
    trace.start()
    with dt:
        with trace.span("test:gap"):
            x.add_(1)
            t_a = time.perf_counter()
            while time.perf_counter() < t_a + 0.02:    # the host's 20 ms
                pass
            t_b = time.perf_counter()
            x.add_(1)
    rec = trace.stop()
    dt.attach(rec)
    adds = [e for e in dt.events() if "add" in e[0].lower()]
    assert len(adds) == 2, dt.events()
    assert abs(adds[0][1] - t_a) < 5e-4
    assert abs(adds[1][1] - t_b) < 5e-4
    idle = dict(dt.read([])["idle_gaps"])
    assert idle.get("test:gap", 0.0) == pytest.approx(0.020, abs=5e-4)


@pytest.mark.cuda
def test_sync_debug_count_equals_host_syncs(cuda_card):
    """The 64x48 rehearsal cell on the card, from its first frame: every
    synchronising operation torch reports is one the program counts."""
    rc, out, err = finish(start([
        "-m", "portbench.progtrace", "--workload", "tiny_medium.tiny",
        "--seed", "3141592653", "--sync-debug", "--from-start",
        "--manifest", MANIFEST, "--data", REHEARSAL]), timeout=600)
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["equal"], (res, err[-3000:])
