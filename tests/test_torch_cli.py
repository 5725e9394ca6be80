"""The port's command line (x264_tpu_torch/cli.py) against x264_tpu's
(x264_tpu/cli.py) on the CPU, tolerance 0: a 48x32 y4m of 8 frames at the
CLI's defaults (preset medium: CABAC, B frames, MB-tree, AQ), to .264,
.mkv and .mp4, with --dump-yuv. The port's CLI runs with --device cpu;
without it, it asks for the card and raises where there is none."""

import os
import subprocess
import sys

import pytest
import torch

from x264_tpu_torch import cli as tcli
from torch_parity import ROOT, cli_both, write_clip

W, H, N = 48, 32, 8


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    write_clip(tmp / "in.y4m")
    return {ext: cli_both(tmp, "defaults", ext, [])
            for ext in ("264", "mkv", "mp4")}


@pytest.mark.parametrize("ext", ["264", "mkv", "mp4"])
def test_cli_defaults_write_the_same_bytes(outputs, ext):
    got = outputs[ext]
    assert got["port"][0] == got["jax"][0] == 0
    assert got["port"][1] == got["jax"][1]
    assert len(got["port"][1]) > 0


@pytest.mark.parametrize("ext", ["264", "mkv", "mp4"])
def test_cli_dump_yuv_is_the_same(outputs, ext):
    got = outputs[ext]
    assert got["port"][2] == got["jax"][2]
    assert len(got["port"][2]) > N * W * H


def test_cli_without_device_raises_without_a_card(tmp_path):
    """The default device is the card: no encode on the CPU behind the
    user's back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    write_clip(tmp_path / "in.y4m", n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--quiet", "-o", str(tmp_path / "x.264"),
                   str(tmp_path / "in.y4m")])
    assert not (tmp_path / "x.264").exists()


def test_cli_runs_as_a_module(tmp_path):
    """`python -m x264_tpu_torch.cli`: help exits 0 and names --device;
    an encode without --device fails where there is no card."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "x264_tpu_torch.cli", "--help"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout
    if torch.cuda.is_available():
        return
    write_clip(tmp_path / "in.y4m", n=1)
    r = subprocess.run([sys.executable, "-m", "x264_tpu_torch.cli", "--quiet",
                        "-o", str(tmp_path / "x.264"),
                        str(tmp_path / "in.y4m")],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
