"""The CAVLC residual coder: the hand-written kernel (csrc/cavlc.cu, via
ops/cavlc.py cavlc_residual_launch) against its plain torch version
(entropy/cavlc_dev.py residual_blocks_plain). This file imports no JAX, so
that its card tests run where JAX is absent;
tests/test_torch_cavlc_twin.py holds the plain version against x264_tpu's
on the same cases.

`residual_blocks_dev` sends CUDA tensors to the kernel and CPU tensors to
the plain version. On the CPU: CPU tensors never reach the kernels'
library; the wrapper refuses a wrong device, dtype, shape, contiguity or
flag before it touches the library; the kernel's tables are
entropy/vlc_tables.py's; an encoded P frame and p_rd_core call the coder
as often as the card launches the kernel. On the card (`cuda`, skipped
elsewhere): the kernel equals the plain version in all four outputs on
every case, the 1080p luma batch included, and launches 5 times per P
frame, M + 2 times per p_rd_core call over M candidates with its intra
candidate and M without. Every output is an integer: every comparison is
exact."""

import os
import re

import numpy as np
import pytest
import torch
from cavlc_cases import cavlc_cases
from x264_tpu_torch.entropy import cavlc_dev
from x264_tpu_torch.entropy import vlc_tables as V
from x264_tpu_torch.ops import _cuda
from x264_tpu_torch.ops import cavlc as tcavlc

CASES = cavlc_cases()
SMALL = sorted(CASES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the plain version is
    ~2,000 small ops a call, which torch's intra-op pool slows on a busy
    CPU. The results do not depend on the thread count (integer ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name, device="cpu", big=False):
    coeffs, nc, chroma_dc = (cavlc_cases(big=True) if big else CASES)[name]
    return (torch.from_numpy(coeffs).to(device),
            torch.from_numpy(nc).to(device), chroma_dc)


def _same(want, got, label):
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (label, i)
        np.testing.assert_array_equal(w.cpu().numpy(), g.cpu().numpy(),
                                      err_msg=f"{label}: output {i}")


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if the wrapper reaches the kernels' library (nvcc)."""
    def refuse():
        raise AssertionError("the wrapper reached the kernels' library")
    monkeypatch.setattr(_cuda, "library", refuse)
    monkeypatch.setattr(tcavlc, "_LIB", {})


def _bad_inputs(kind):
    coeffs, nc, _ = _inputs("l16_nc0_1")
    chroma_dc = False
    if kind == "dtype":
        coeffs = coeffs.to(torch.int64)
    elif kind == "nc_dtype":
        nc = nc.to(torch.int64)
    elif kind == "too_many_coeffs":
        coeffs = torch.zeros((coeffs.shape[0], 17), dtype=torch.int32)
    elif kind == "empty_batch":
        coeffs, nc = coeffs[:0], nc[:0]
    elif kind == "nc_shape":
        nc = nc[:-1]
    elif kind == "not_contiguous":
        coeffs = torch.zeros((coeffs.shape[0], 32), dtype=torch.int32)[:, ::2]
    elif kind == "nc_missing":
        nc = None
    elif kind == "chroma_dc_not_bool":
        chroma_dc = 1
    return coeffs, nc, chroma_dc


@pytest.mark.parametrize("kind", ["device", "dtype", "nc_dtype",
                                  "too_many_coeffs", "empty_batch",
                                  "nc_shape", "not_contiguous",
                                  "nc_missing", "chroma_dc_not_bool"])
def test_cavlc_launch_checks_before_the_library(kind, no_library,
                                                monkeypatch):
    """cavlc_residual_launch raises on CPU tensors without building or
    loading the library; with the device check passed (the CPU tensors
    stand in for CUDA ones), on a wrong dtype, a wrong or empty shape, a
    strided input, a missing nC or a chroma_dc that is not a bool."""
    n0 = tcavlc.cavlc_residual_launch.launches
    if kind == "device":
        with pytest.raises(ValueError, match="CUDA"):
            tcavlc.cavlc_residual_launch(*_inputs("l16_nc0_1"))
    else:
        monkeypatch.setattr(tcavlc, "_device", lambda t, name: t.device)
        err = {"dtype": (TypeError, "dtype"), "nc_dtype": (TypeError, "dtype"),
               "too_many_coeffs": (ValueError, "shape"),
               "empty_batch": (ValueError, "shape"),
               "nc_shape": (ValueError, "shape"),
               "not_contiguous": (ValueError, "contiguous"),
               "nc_missing": (TypeError, "tensor"),
               "chroma_dc_not_bool": (TypeError, "bool")}[kind]
        with pytest.raises(err[0], match=err[1]):
            tcavlc.cavlc_residual_launch(*_bad_inputs(kind))
    assert tcavlc.cavlc_residual_launch.launches == n0


@pytest.mark.parametrize("name", SMALL)
def test_cpu_tensors_take_the_plain_path(name, no_library):
    """residual_blocks_dev on CPU tensors is the plain version, and never
    reaches the kernels' library or counts a launch."""
    n0 = tcavlc.cavlc_residual_launch.launches
    args = _inputs(name)
    _same(cavlc_dev.residual_blocks_plain(*args),
          cavlc_dev.residual_blocks_dev(*args), name)
    assert tcavlc.cavlc_residual_launch.launches == n0


def _cu_tables():
    src = os.path.join(os.path.dirname(_cuda.SOURCES[0]), "cavlc.cu")
    with open(src) as f:
        text = f.read()
    return {name: np.array([int(x) for x in body.replace("\n", " ")
                            .split(",")])
            for name, body in re.findall(
                r"__constant__ uint8_t (\w+)\[\d+\] = \{([^}]*)\};", text)}


def test_kernel_tables_are_vlc_tables():
    """The __constant__ tables of csrc/cavlc.cu hold entropy/vlc_tables.py's
    codes and lengths, flat, entry for entry."""
    tables = _cu_tables()
    want = {"kCoeff0Token": "COEFF0_TOKEN", "kCoeffToken": "COEFF_TOKEN",
            "kTotalZeros": "TOTAL_ZEROS", "kTotalZeros2x2": "TOTAL_ZEROS_2x2",
            "kTotalZeros2x4": "TOTAL_ZEROS_2x4", "kRunBefore": "RUN_BEFORE"}
    assert len(tables) == 2 * len(want)
    for cu, py in want.items():
        for part in ("Code", "Len"):
            np.testing.assert_array_equal(
                tables[cu + part],
                getattr(V, f"{py}_{part.upper()}").reshape(-1),
                err_msg=cu + part)


def _coder_calls(device, monkeypatch):
    """(calls for one ultrafast CAVLC P frame at 64x48, for p_rd_core over
    M = 4 candidates with its intra candidate, and without it): kernel
    launches on a CUDA device, calls of the plain version on the CPU."""
    from x264_tpu_torch import param_default_preset
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.encoder.encoder import (TYPE_IDR, TYPE_P, Encoder,
                                                Picture)
    dev = torch.device(device)
    if dev.type == "cuda":
        def count():
            return tcavlc.cavlc_residual_launch.launches
    else:
        calls = [0]
        plain = cavlc_dev.residual_blocks_plain

        def counted(*a, **kw):
            calls[0] += 1
            return plain(*a, **kw)
        monkeypatch.setattr(cavlc_dev, "residual_blocks_plain", counted)

        def count():
            return calls[0]
    rng = np.random.default_rng(7)
    w, h = 64, 48
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.rc.rc_method = 0
    p.rc.qp_constant = 26
    enc = Encoder(p, device=dev)
    frames = [[rng.integers(0, 256, (h, w)).astype(np.uint8),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)]
              for _ in range(2)]
    counts = []
    for idx, ftype in ((0, TYPE_IDR), (1, TYPE_P)):
        n0 = count()
        enc._enqueue_frame(enc._pad_to_mb(frames[idx]), ftype,
                           Picture(frames[idx], pts=idx), idx)
        enc._pipe.clear()
        counts.append(count() - n0)
    mbw, mbh, M = w // 16, h // 16, 4
    n = mbw * mbh
    y = torch.from_numpy(frames[1][0]).to(dev)
    cand_pred = torch.from_numpy(rng.integers(0, 256, (M, n, 16, 16))
                                 .astype(np.int32)).to(dev)
    cand_mv = torch.from_numpy(rng.integers(-64, 65, (M, n, 4, 2))
                               .astype(np.int32)).to(dev)
    mvp = torch.from_numpy(rng.integers(-64, 65, (n, 2))
                           .astype(np.int32)).to(dev)
    qp = torch.full((mbh, mbw), 26, dtype=torch.int32, device=dev)
    i16 = torch.from_numpy(rng.integers(0, 4, (mbh, mbw))
                           .astype(np.int32)).to(dev)
    for intra_rd in (True, False):
        n0 = count()
        inter.p_rd_core(y, cand_pred, cand_mv, mvp, qp, False, i16,
                        mbw=mbw, mbh=mbh, two_refs=False, intra_rd=intra_rd)
        counts.append(count() - n0)
    return counts


def test_residual_coder_calls_per_frame_and_rd_call(monkeypatch):
    """On the CPU the plain version runs 5 times for an I and for a P
    frame (luma 16, luma DC, luma AC, chroma DC, chroma AC) and M + 2 / M
    times per p_rd_core call: the launches the card test expects."""
    assert _coder_calls("cpu", monkeypatch) == [5, 5, 4 + 2, 4]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CAVLC kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMALL + ["luma_1080p"])
def test_cavlc_kernel_matches_the_torch_path(cuda_device, name):
    """cavlc_residual_kernel through residual_blocks_dev against
    residual_blocks_plain on the same CUDA tensors, tolerance 0, in all
    four outputs (dtype and shape too), one launch a call."""
    args = _inputs(name, cuda_device, big=name == "luma_1080p")
    want = cavlc_dev.residual_blocks_plain(*args)
    n0 = tcavlc.cavlc_residual_launch.launches
    got = cavlc_dev.residual_blocks_dev(*args)
    torch.cuda.synchronize()
    assert tcavlc.cavlc_residual_launch.launches == n0 + 1
    _same(want, got, name)


@pytest.mark.cuda
def test_cavlc_kernel_launches_per_frame_and_rd_call(cuda_device,
                                                     monkeypatch):
    """On the card an I and a CAVLC P frame each launch the kernel 5 times,
    p_rd_core over M = 4 candidates M + 2 times with its intra candidate
    and M times without."""
    assert _coder_calls(cuda_device, monkeypatch) == [5, 5, 4 + 2, 4]
