"""The port's deblock (x264_tpu_torch.ops.deblock) against x264_tpu's
`deblock_frame` (a jnp lax.scan, run on the CPU): the same numpy inputs
from a seed go through both, with tolerance 0 (every output is an
integer). `deblock_ref` is held in its three orders: "diagonal"
(x264_tpu's schedule), "raster" (the MB order of the first CUDA kernel's
rows) and "phased" (the half-steps of the CUDA kernel, whose schedule is
also checked pixel by pixel against raster order). The strengths come
from the port's `intra_strengths`,
`compute_strengths` and `compute_strengths_b` (held against x264_tpu's in
test_torch_inter.py and test_torch_bframe.py) or are random."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x264_tpu.ops import deblock as jdeblock
from x264_tpu_torch.ops import deblock as tdeblock

# (name, width, height, strengths, (a_off, b_off, chroma_qp_offset), qp):
# one JAX compile per size (the offsets are static arguments), so each size
# takes one offset triple and the three triples spread over the sizes; qp
# "full" draws every MB's QP from 0-51 with both table ends present, "mid"
# from 24-44
CASES = [
    ("64x48_intra", 64, 48, "intra", (0, 0, 0), "mid"),
    ("64x48_p1_mb", 64, 48, "p1_mb", (0, 0, 0), "mid"),
    ("64x48_p2_mb", 64, 48, "p2_mb", (0, 0, 0), "mid"),
    ("64x48_p1_4x4", 64, 48, "p1_4x4", (0, 0, 0), "mid"),
    ("64x48_p2_4x4", 64, 48, "p2_4x4", (0, 0, 0), "mid"),
    ("64x48_b", 64, 48, "b", (0, 0, 0), "mid"),
    ("64x48_random", 64, 48, "random", (0, 0, 0), "full"),
    ("48x32_intra_hi", 48, 32, "intra", (12, -12, 12), "full"),
    ("48x32_random_hi", 48, 32, "random", (12, -12, 12), "full"),
    ("48x32_p2_4x4_hi", 48, 32, "p2_4x4", (12, -12, 12), "full"),
    ("16x16_intra_lo", 16, 16, "intra", (-12, 12, -12), "mid"),
    ("16x16_random_lo", 16, 16, "random", (-12, 12, -12), "full"),
    ("16x64_random_lo", 16, 64, "random", (-12, 12, -12), "full"),
    ("16x64_b_lo", 16, 64, "b", (-12, 12, -12), "mid"),
    ("128x16_random_hi", 128, 16, "random", (12, -12, 12), "full"),
    ("128x16_p2_mb_hi", 128, 16, "p2_mb", (12, -12, 12), "mid"),
    # 13 MB rows: more than one band of the kernel and a multiple of none
    # of the band heights it was timed with (1 aside)
    ("32x208_random_hi", 32, 208, "random", (12, -12, 12), "full"),
]
_BY_NAME = {c[0]: c for c in CASES}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _strengths(kind, mbw, mbh, rng):
    """(bs_v, bs_h) as numpy int32 [mbh, mbw, 4, 4]; intra: one array
    twice, as intra_strengths returns one tensor twice."""
    if kind == "intra":
        bs, bs_h = tdeblock.intra_strengths(mbw, mbh, "cpu")
        assert bs is bs_h
        return bs.numpy(), bs.numpy()
    if kind == "random":
        return (rng.integers(0, 5, (mbh, mbw, 4, 4)).astype(np.int32),
                rng.integers(0, 5, (mbh, mbw, 4, 4)).astype(np.int32))
    nnz4 = (rng.random((mbh * 4, mbw * 4)) < 0.3).astype(np.int32)
    if kind == "b":
        use0 = rng.random((mbh, mbw)) < 0.7
        use1 = ~use0 | (rng.random((mbh, mbw)) < 0.4)
        mv0, mv1 = (rng.integers(-9, 10, (mbh, mbw, 2)).astype(np.int32)
                    for _ in range(2))
        bs = tdeblock.compute_strengths_b(
            _t(nnz4), _t(use0), _t(use1), _t(mv0), _t(mv1), mbw=mbw,
            mbh=mbh)
    else:
        intra = rng.random((mbh, mbw)) < 0.2
        grain = (mbh, mbw) if kind.endswith("_mb") else (mbh * 4, mbw * 4)
        mv = rng.integers(-9, 10, (*grain, 2)).astype(np.int32)
        ref = (rng.integers(0, 2, (mbh, mbw)).astype(np.int32)
               if kind.startswith("p2") else None)
        bs = tdeblock.compute_strengths(
            _t(intra), _t(nnz4), _t(mv), mbw=mbw, mbh=mbh,
            ref_mb=None if ref is None else _t(ref))
    return tuple(b.numpy() for b in bs)


@lru_cache(maxsize=None)
def _case(name):
    """The case's numpy inputs and x264_tpu's planes (JAX on the CPU)."""
    _, w, h, kind, (a_off, b_off, cqpo), qp_kind = _BY_NAME[name]
    mbw, mbh = w // 16, h // 16
    rng = np.random.default_rng(100 + CASES.index(_BY_NAME[name]))
    yy, xx = np.mgrid[0:h, 0:w]
    # blocky content so both the normal and the strong filters fire
    y = np.clip(110 + 24 * ((xx // 16 + yy // 16) % 2)
                + 10 * ((xx // 4 + yy // 4) % 2)
                + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    u = np.clip(120 + 14 * ((cx // 8 + cy // 8) % 2)
                + rng.integers(-3, 4, (h // 2, w // 2)), 0, 255) \
        .astype(np.uint8)
    v = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
    bs_v, bs_h = _strengths(kind, mbw, mbh, rng)
    if qp_kind == "full":
        qp = rng.integers(0, 52, (mbh, mbw)).astype(np.int32)
        qp.flat[0], qp.flat[-1] = 0, 51
    else:
        qp = rng.integers(24, 45, (mbh, mbw)).astype(np.int32)
    inputs = (y, u, v, bs_v, bs_h, qp)
    kw = dict(mbw=mbw, mbh=mbh, a_off=a_off, b_off=b_off,
              chroma_qp_offset=cqpo)
    want = jdeblock.deblock_frame(*[jnp.asarray(a) for a in inputs], **kw)
    return inputs, kw, tuple(np.asarray(p) for p in want)


def _torch_inputs(inputs, intra):
    ts = [_t(a) for a in inputs]
    if intra:
        ts[4] = ts[3]                    # bs_h is bs_v, as in the encoder
    return ts


@pytest.mark.parametrize("order", ["diagonal", "raster", "phased"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_deblock_ref_matches_jax(name, order):
    inputs, kw, want = _case(name)
    got = tdeblock.deblock_ref(
        *_torch_inputs(inputs, _BY_NAME[name][3] == "intra"), order=order,
        **kw)
    changed = sum(int((w != s).sum()) for w, s in zip(want, inputs[:3]))
    assert changed > 0, "the filter changed no pixel: the case tests nothing"
    for w, g in zip(want, got):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("name", ["64x48_intra", "48x32_p2_4x4_hi"])
def test_deblock_frame_on_cpu_is_the_ref(name):
    """On CPU tensors deblock_frame is deblock_ref: same planes, inputs
    untouched (the aliased intra strengths too), no kernel launch."""
    inputs, kw, want = _case(name)
    ts = _torch_inputs(inputs, _BY_NAME[name][3] == "intra")
    before = [t.clone() for t in ts]
    n0 = tdeblock.deblock_frame.launches
    got = tdeblock.deblock_frame(*ts, **kw)
    assert tdeblock.deblock_frame.launches == n0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())
    for b, t in zip(before, ts):
        assert torch.equal(b, t)


def _footprint(phase, x, y):
    """(read, written) luma rectangles (r0, r1, c0, c1) of one MB phase: a
    line filter reads p3..q3 and writes at most p2..q2 across each edge.
    Each chroma footprint is the luma one halved, so its conflicts are a
    subset of these."""
    if phase == "v":
        return ((16 * y, 16 * y + 16, 16 * x - 4, 16 * x + 16),
                (16 * y, 16 * y + 16, 16 * x - 3, 16 * x + 15))
    return ((16 * y - 4, 16 * y + 16, 16 * x, 16 * x + 16),
            (16 * y - 3, 16 * y + 15, 16 * x, 16 * x + 16))


def _overlap(a, b):
    return a[0] < b[1] and b[0] < a[1] and a[2] < b[3] and b[2] < a[3]


@pytest.mark.parametrize("mbw, mbh", [(1, 1), (1, 5), (5, 1), (6, 5),
                                      (4, 9)])
def test_phased_schedule_keeps_raster_order(mbw, mbh):
    """phased_steps has 2 (mbw + mbh - 1) half-steps that run every MB's V
    and H phase once; inside a step no pixel that one phase writes is read
    or written by another, and any two phases that share a pixel one of
    them writes run in raster order (MB by MB, V before H)."""
    steps = tdeblock.phased_steps(mbw, mbh)
    assert len(steps) == 2 * (mbw + mbh - 1)
    step_of = {}
    for s, (phase, xs, ys) in enumerate(steps):
        assert phase in ("v", "h") and len(xs) == len(ys) > 0
        for x, y in zip(xs, ys):
            assert (phase, x, y) not in step_of
            step_of[(phase, x, y)] = s
    assert len(step_of) == 2 * mbw * mbh

    def raster(phase, x, y):
        return 2 * (y * mbw + x) + (phase == "h")

    ops = list(step_of)
    for i, a in enumerate(ops):
        read_a, wrote_a = _footprint(*a)
        for b in ops[i + 1:]:
            read_b, wrote_b = _footprint(*b)
            if _overlap(wrote_a, read_b) or _overlap(wrote_b, read_a):
                assert step_of[a] != step_of[b], (a, b)
                assert (step_of[a] < step_of[b]) == \
                    (raster(*a) < raster(*b)), (a, b)


def test_deblock_ref_rejects_an_unknown_order():
    inputs, kw, _ = _case("16x16_intra_lo")
    with pytest.raises(ValueError, match="order"):
        tdeblock.deblock_ref(*_torch_inputs(inputs, True), order="zigzag",
                             **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the deblock kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, 1])
@pytest.mark.parametrize("name", ["64x48_intra", "64x48_b",
                                  "48x32_random_hi", "128x16_p2_mb_hi",
                                  "16x64_random_lo", "32x208_random_hi"])
def test_deblock_kernel_matches_ref(cuda_device, name, grid):
    """deblock_cuda (one launch, all blocks or one block walking every
    band; frames of fewer MB rows than a band, of whole bands and of a
    part band) against deblock_ref on the same inputs, tolerance 0."""
    inputs, kw, _ = _case(name)
    intra = _BY_NAME[name][3] == "intra"
    want = tdeblock.deblock_ref(*_torch_inputs(inputs, intra), **kw)
    ts = [_t(a).to(cuda_device) for a in inputs]
    if intra:
        ts[4] = ts[3]
    n0 = tdeblock.deblock_frame.launches
    got = (tdeblock.deblock_frame(*ts, **kw) if grid is None
           else tdeblock.deblock_cuda(*ts, grid=grid, **kw))
    torch.cuda.synchronize()
    assert tdeblock.deblock_frame.launches == n0 + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())
