"""roofline.py's counts at the 1080p shapes of the port's launches,
pinned to the figures of PERF.md section 6 that depend on the
shapes alone, and the peak it takes for the benchmark's card."""

import pytest
import torch

from portbench import roofline as R

MBW, MBH = 120, 68           # 1920 x 1088


def test_peak_of_the_card():
    hbm, ops = R.rates("NVIDIA H100 80GB HBM3")
    assert hbm == 3.35e12
    assert ops == pytest.approx(33.4541e12, rel=1e-5)
    assert R.rates("some other card") is None


def test_lowres_scan():
    a = {"lsrc": torch.zeros(544, 960, dtype=torch.int32),
         "lref": torch.zeros(544 + 18, 960 + 18, dtype=torch.int32),
         "rl": 8, "lam": 4}
    out = torch.zeros(68, 120, 2, dtype=torch.int32)
    assert R.motion_work("lowres_scan_launch", a, [out]) == (4_352_784,
                                                              51_881_280)


@pytest.mark.parametrize("wrapper,radius,shapes,ops", [
    ("refine_launch", 4, True, 52_876_800),
    ("esa_launch", 16, False, 622_036_800)])
def test_fullpel_ops(wrapper, radius, shapes, ops):
    key = "refine" if wrapper == "refine_launch" else "me_range"
    a = {"y_src": R.Meta(torch.empty(1088, 1920, dtype=torch.uint8)),
         key: radius, "shapes": shapes}
    assert R.motion_work(wrapper, a, [])[1] == ops


def test_deblock_bytes():
    a = {"y": R.Meta(torch.empty(1088, 1920, dtype=torch.uint8)),
         "u": torch.zeros(544, 960, dtype=torch.uint8),
         "v": torch.zeros(544, 960, dtype=torch.uint8),
         "bs_v": torch.zeros(MBH, MBW, 4, 4, dtype=torch.int32),
         "bs_h": torch.zeros(MBH, MBW, 4, 4, dtype=torch.int32),
         "qp_mb": torch.zeros(MBH * MBW, dtype=torch.int32), "mbh": MBH}
    assert R.deblock_work(a) == (7_344_276, 0)
    a["bs_v"][:, 1:, 0] = 2               # every MB's left edge but the first
    lines = 4 * 4 * MBH * (MBW - 1)      # 4 entries of 4 lines each
    assert R.deblock_work(a)[1] == (R.OPS_PER_LUMA_LINE * lines
                                    + R.OPS_PER_CHROMA_LINE * lines)


def test_subpel_pairs_counts_shared_mvs_once():
    lane_mv = torch.zeros(3, 2, 2, 2, dtype=torch.int32)
    lane_mv[2] += 1                        # lane 2 has its own MV
    masks = torch.ones(3, 16, dtype=torch.int32)
    weighed, computed = R.subpel_pairs(lane_mv, masks)
    assert weighed == 3 * 16 * 4
    assert computed == 2 * 16 * 4          # lane 1 reads lane 0's SATDs


def test_light_keeps_small_tensors_and_sizes_of_large_ones():
    small, big = torch.arange(10), torch.zeros(2000, 1000)
    s, b = R.light([small, big])
    assert torch.equal(s, small) and s.data_ptr() != small.data_ptr()
    assert isinstance(b, R.Meta) and b.numel() == 2_000_000


def test_capture_wraps_the_launches_and_puts_them_back():
    from x264_tpu_torch.ops import commit, deblock, motion
    from portbench.devtrace import Capture
    before = {n: getattr(motion, n) for n in ("lowres_scan_launch",
                                              "subpel_launch")}
    counts = {n: f.launches for n, f in before.items()}
    with Capture():
        wrapped = motion.lowres_scan_launch
        assert wrapped is not before["lowres_scan_launch"]
        wrapped.launches += 1             # as a launch counts itself
        assert commit.commit_launch.__wrapped__ is not None
        assert deblock.deblock_launch.__name__ == "deblock_launch"
    assert motion.lowres_scan_launch is before["lowres_scan_launch"]
    assert motion.lowres_scan_launch.launches == \
        counts["lowres_scan_launch"] + 1
    assert motion.subpel_launch.launches == counts["subpel_launch"]
