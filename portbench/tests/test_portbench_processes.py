"""A run of the benchmark is one process and leaves none behind: each run
here starts in a session of its own, and once it has exited no process
of that session may remain. Runs through the CPU rehearsal entry
(entry.py, 64x48) and, on a host without a card, the real command."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def session_members(sid):
    """pids of live processes whose session id is `sid` (from /proc)."""
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z" and int(fields[3]) == sid:
            found.append(int(d))
    return found


def start(argv):
    return subprocess.Popen([sys.executable] + argv, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def finish(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    time.sleep(0.2)
    left = session_members(proc.pid)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    assert left == [], f"processes left in the run's session: {left}"
    return proc.returncode, out, err


def rehearsal(fault, workload, seconds=2, trace=0):
    return [os.path.join(HERE, "entry.py"), fault, "--workload", workload,
            "--seed", "3141592653", "--seconds", str(seconds),
            "--trace", str(trace)]


def last_line(out):
    line = out.strip().splitlines()[-1]
    res = json.loads(line)
    assert KEYS <= set(res), res.keys()
    return res


@pytest.mark.parametrize("workload,trace", [("tiny_medium.tiny", 0),
                                            ("tiny_live.tiny", 1)])
def test_sound_run_prints_result_and_leaves_nothing(workload, trace):
    rc, out, err = finish(start(rehearsal("none", workload, trace=trace)))
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True, err[-3000:]
    assert list(res)[-1] == "check"
    assert "check mismatched_samples: 0 (limit 0)" in err


def test_failed_comparison_leaves_nothing():
    rc, out, err = finish(start(rehearsal("stale_recon",
                                          "tiny_live.tiny")))
    assert rc == 0, err[-3000:]
    assert last_line(out)["correct"] is False


def test_refused_parameters_leave_nothing():
    rc, out, err = finish(start(rehearsal("none", "tiny_refused.tiny")))
    assert rc != 0
    assert '"correct"' not in out
    assert "interlaced" in err


def test_sigterm_in_the_window_leaves_nothing():
    proc = start(rehearsal("none", "tiny_live.tiny", seconds=60))
    t0 = time.time()
    for line in proc.stderr:
        if line.startswith("window: start"):
            break
        assert time.time() - t0 < 120, "no window started"
    time.sleep(1.0)
    proc.send_signal(signal.SIGTERM)
    rc, out, _ = finish(proc)
    assert rc == -signal.SIGTERM
    assert out.strip() == ""


def test_real_command_without_a_card_fails_and_leaves_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc, out, err = finish(start([
        "portbench/run.py", "--workload", "medium_crf23_1080p.sports",
        "--seed", "1", "--seconds", "1", "--trace", "0"]))
    assert rc != 0
    assert out.strip() == ""
    assert "no CUDA card" in err


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_on_the_card(cuda_card, trace):
    """The 64x48 rehearsal cells through the card's path (kernels, the
    profiler and the launch capture when traced): correct, one process."""
    argv = rehearsal("none", "tiny_medium.tiny", seconds=3, trace=trace)
    argv[argv.index("--trace") + 1:] = [str(trace), "--device", "cuda"]
    rc, out, err = finish(start(argv))
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
