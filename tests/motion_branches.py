"""Inputs that reach the branches of the motion kernels' mapping
(x264_tpu_torch/csrc/motion.cu), shared by tests/test_torch_motion.py,
which holds the port's plain forms against x264_tpu on them on the CPU,
and chip_smoke.py, which holds the kernels against the plain forms on
them on the card. Imports neither jax nor x264_tpu.

Each generator takes a 48x32 (current, reference) luma pair as uint8
numpy arrays (both callers pass frames 1 and 0 of moving_frames(2, 48,
32, seed=11)) and the torch device to put the tensors on."""

import numpy as np
import torch

from x264_tpu_torch.ops import mc
from x264_tpu_torch.ops import motion as MO

# lane MVs of the qpel refine's branch cases, per kind: (low, high) of
# the random full-pel MVs, and which lanes copy another lane's MV
LANE_KINDS = {
    "equal": ((-6, 7), "every lane the 16x16 lane's MV"),
    "mixed": ((-6, 7), "lanes 0, 3, 6 share one MV, 2, 5, 8 copy the lane "
                       "before"),
    "distinct": ((-6, 7), "every lane its own MV"),
    "edge_far": ((20, 46), "windows past the right and bottom plane edges"),
    "edge_near": ((-60, -25), "windows past the left and top plane edges"),
}


def lane_mvs(kind, lanes, mbh, mbw, seed):
    """[lanes, mbh, mbw, 2] int32 full-pel lane MVs of LANE_KINDS[kind],
    made with numpy from `seed`."""
    (lo, hi), _ = LANE_KINDS[kind]
    rng = np.random.default_rng(seed)
    mvs = rng.integers(lo, hi, (lanes, mbh, mbw, 2)).astype(np.int32)
    if kind == "equal":
        mvs[:] = mvs[0]
    elif kind == "mixed":
        for lane in range(1, lanes):
            if lane % 3 == 0:
                mvs[lane] = mvs[0]
            elif lane % 3 == 2:
                mvs[lane] = mvs[lane - 1]
    return mvs


def _planes(y, ref, dev):
    """(current luma, padded reference luma) on `dev`."""
    return (torch.from_numpy(np.ascontiguousarray(y)).to(dev),
            mc.pad_plane(torch.from_numpy(np.ascontiguousarray(ref))
                         .to(dev)))


def subpel_lane_cases(y, ref, dev):
    """The qpel refine's branch cases: lane MVs of every LANE_KINDS kind
    at 1, 5 and 9 lanes (their partition masks: 1 lane is
    subpel_refine_mc's, no MVP; 5 and 9 have a random qpel MVP), lam 6.
    Yields (label, y, hpel, lane_mv [L, mbh, mbw, 2], mvp_q [n, 2] or
    None, lam)."""
    h, w = y.shape
    y, yp = _planes(y, ref, dev)
    hpel = mc.hpel_planes(yp)
    for k, kind in enumerate(LANE_KINDS):
        for lanes in (1, 5, 9):
            seed = 100 + 10 * k + lanes
            mv = torch.from_numpy(lane_mvs(kind, lanes, h // 16, w // 16,
                                           seed)).to(dev)
            mvp = None if lanes == 1 else torch.from_numpy(
                np.random.default_rng(seed).integers(
                    -40, 40, ((h // 16) * (w // 16), 2)).astype(np.int32)
            ).to(dev)
            yield f"{w}x{h} lanes {kind}, L {lanes}", y, hpel, mv, mvp, 6


def refine_edge_cases(y, ref, dev):
    """Full-pel searches whose windows leave the plane (the kernel's clamp
    path; the encoder's searches never do): the refine (radius 4, both
    lane sets) around seeds 20-40 pixels past each edge, and the ESA at
    me_range 32 (the last MB column's window passes the right edge).
    Yields (label, launch, plain, args)."""
    h, w = y.shape
    y, yp = _planes(y, ref, dev)
    rng = np.random.default_rng(12)

    def field(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, (h // 16, w // 16, 2))
                                .astype(np.int32)).to(dev)

    for lo, hi in ((-40, -20), (20, 40)):
        for shapes in (False, True):
            yield (f"refine, seeds {lo}..{hi}, {9 if shapes else 1} lanes",
                   MO.refine_launch, MO.fullpel_plain,
                   (yp, y, field(lo, hi), field(-30, 30), 6, 4, shapes))
    for shapes in (False, True):
        yield (f"ESA me_range 32, {9 if shapes else 1} lanes",
               MO.esa_launch,
               lambda yp, y, mvp, lam, r, sh: MO.fullpel_plain(
                   yp, y, None, mvp, lam, r, sh),
               (yp, y, None, 6, 32, shapes))
