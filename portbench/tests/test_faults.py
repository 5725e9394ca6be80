"""A run with its timed path broken underneath comes out not correct:
the whole harness runs (entry.py, on the CPU at 64x48, its look for a
card skipped) with each fault that a cell of this benchmark can have
planted, and with the benchmark's control in the reference's place.
Faults the cells cannot have (half of a batch, an exchange between
chips) have no case: each call encodes one frame on one card."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.mark.parametrize("fault", ["stale_recon", "altered_nal", "control"])
@pytest.mark.parametrize("workload", ["tiny_medium.tiny", "tiny_live.tiny"])
def test_broken_path_is_not_correct(fault, workload):
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "entry.py"), fault,
         "--workload", workload, "--seed", "2718281828", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, r.stderr[-3000:]
    assert res["failed"] >= 1


def test_sound_path_is_correct():
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "entry.py"), "none",
         "--workload", "tiny_medium.tiny", "--seed", "2718281828",
         "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
