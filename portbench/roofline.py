"""The benchmark's yardstick for the port's hand-written kernels: the
card's peaks and, for each kernel, the least time the card could take
for one launch on that launch's own inputs.

The arithmetic is copied from chip_smoke.py (`commit_bound`,
`deblock_bound`, `motion_bound`, `subpel_pairs`; section 6 of PERF.md
gives their derivation) and frozen here: later changes to the program
cannot move it. Each bound is the larger of the bytes the launch must
move over the memory rate and the integer instructions its work needs
over the issue rate (SMs x 128 lane instructions a clock x the maximum
SM clock). Counts take the wrapper's arguments by name
(`ops/commit.py commit_launch`, `ops/deblock.py deblock_launch`,
`ops/motion.py *_launch`).
"""

from __future__ import annotations

# Published figures of the cards the benchmark knows, by the name that
# torch.cuda.get_device_name() gives: HBM bytes/s (data sheet), SMs, the
# maximum SM clock (nvidia-smi clocks.max.sm on the benchmark's card) and
# the lane instructions an SM issues a clock (4 schedulers x 32 lanes).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "sms": 132,
                              "max_sm_mhz": 1980.0,
                              "lane_ops_per_sm_clock": 128},
}

# which profiler kernel each wrapper launches (one launch per call)
KERNEL_OF = {
    "commit_launch": "commit_frame_kernel",
    "deblock_launch": "deblock_frame_kernel",
    "lowres_scan_launch": "me_lowres_scan_kernel",
    "refine_launch": "me_fullpel_kernel",
    "esa_launch": "me_fullpel_kernel",
    "subpel_launch": "me_subpel_kernel",
}

# commit: integer ops per reconstructed intra pixel (forward and inverse
# transform 5 + 5, quant 5, dequant 2, prediction, residual, rounding and
# clip 5, DC transforms and mode sums 2) and per I_4x4 pixel (edge
# vectors and their filters)
OPS_PER_PIXEL = 24
OPS_PER_I4_PIXEL = 6
# deblock: integer ops of one filtered line (edge tests, delta, clips and
# taps), counted only for lines whose strength is not 0
OPS_PER_LUMA_LINE = 60
OPS_PER_CHROMA_LINE = 30
# motion: a packed byte SAD (VABSDIFF4 with accumulate) covers 4 pixels;
# per MB and offset 6 (one lane) or 16 (nine lanes) more for the lanes and
# the MV rate; a computed qpel (4x4 block, candidate) 64 (16 dp4a, 16
# butterflies, 16 |.|, 8 max, 8 adds) plus 1 per averaged row; per lane
# and candidate a multiply-add per weighed block and 14
PIXELS_PER_SAD_OP = 4
OPS_PER_OFFSET = {1: 6, 9: 16}
OPS_PER_SATD_BLOCK = 64
OPS_PER_AVG_ROW = 1
OPS_PER_LANE_CAND = 14


def rates(device_name: str):
    """(HBM bytes/s, integer lane instructions/s) of the named card, or
    None when the table does not know it."""
    pk = PEAKS.get(device_name)
    if pk is None:
        return None
    return (pk["hbm_bytes_per_s"],
            pk["sms"] * pk["lane_ops_per_sm_clock"] * pk["max_sm_mhz"] * 1e6)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def commit_work(a: dict, out, recon):
    """(bytes, ops) of one commit_launch: every output written once; of
    the inputs what this frame's MBs read (an intra MB its 384 source
    bytes, modes, QPs and I_4x4 flag, its 16 I_4x4 modes if it is I_4x4;
    an inter MB its 384 bytes of inter reconstruction), the intra mask,
    the quant tables and the progress words."""
    maps = [a["i16_mode"], a["chroma_mode"], a["qp_mb"], a["qpc_mb"]]
    n = a["mbw"] * a["mbh"]
    intra, i4 = a.get("is_intra"), a.get("i4_mask")
    n_intra = n if intra is None else int(intra.sum())
    n_i4 = 0 if i4 is None else int((i4 if intra is None else i4 & intra)
                                    .sum())
    per_intra = 384 + sum(m.element_size() for m in maps)
    nbytes = n_intra * per_intra + (n - n_intra) * 384
    if i4 is not None:
        nbytes += (n_intra * i4.element_size()
                   + n_i4 * 16 * a["i4_modes"].element_size())
    if intra is not None:
        nbytes += n * intra.element_size()
    nbytes += sum(_nbytes(t) for t in list(out.values()) + list(recon))
    nbytes += 208 * 4 + (a["mbh"] + 1) * 4          # quant tables, progress
    ops = OPS_PER_PIXEL * 384 * n_intra + OPS_PER_I4_PIXEL * 256 * n_i4
    return nbytes, ops


def deblock_work(a: dict):
    """(bytes, ops) of one deblock_launch: the planes read and written
    once, both strength tensors and the QP map as int32, the progress
    words; the ops of the lines whose strength is not 0 (the picture's
    left and top edges have none)."""
    y, u, v, bs_v, bs_h, qp = (a[k] for k in ("y", "u", "v", "bs_v",
                                              "bs_h", "qp_mb"))
    nbytes = (2 * sum(p.numel() for p in (y, u, v))
              + 4 * (bs_v.numel() + bs_h.numel() + qp.numel())
              + 4 * (a["mbh"] + 1))
    bv, bh = bs_v.clone(), bs_h.clone()
    bv[:, 0, 0] = 0
    bh[0, :, 0] = 0
    luma = 4 * int((bv > 0).sum() + (bh > 0).sum())
    chroma = 4 * int((bv[:, :, 0::2] > 0).sum() + (bh[:, :, 0::2] > 0).sum())
    return nbytes, OPS_PER_LUMA_LINE * luma + OPS_PER_CHROMA_LINE * chroma


def subpel_pairs(lane_mv, masks):
    """The (lane, 4x4 block) pairs of a qpel refine over all MBs: those
    its masks weigh, and those me_subpel_kernel computes (a weighed pair
    whose SATDs no earlier lane with the same full-pel MV computes).
    lane_mv [L, mbh, mbw, 2], masks [L, 16]. Returns (weighed, computed)."""
    import torch
    L = lane_mv.shape[0]
    mv = lane_mv.reshape(L, -1, 2)
    w = masks != 0                                      # [L, 16]
    same = (mv[:, None] == mv[None]).all(-1)            # [j, l, n]
    order = torch.arange(L, device=mv.device)
    before = (order[:, None] < order[None, :])[:, :, None]
    shared = (same & before)[..., None] & w[:, None, None, :]
    weighed = int(w.sum()) * mv.shape[1]
    return weighed, weighed - int((shared.any(0) & w[:, None, :]).sum())


def motion_work(wrapper: str, a: dict, outs: list):
    """(bytes, ops) of one motion launch: each input tensor read once and
    each output written once; the instructions of its candidates (the
    qpel refine only the 4x4 blocks it computes)."""
    import torch
    ins = [t for t in a.values() if isinstance(t, (torch.Tensor, Meta))]
    nbytes = sum(_nbytes(t) for t in ins + outs)
    if wrapper == "lowres_scan_launch":
        n, k = a["lsrc"].numel() // 64, (2 * a["rl"] + 1) ** 2
        ops = n * k * (64 // PIXELS_PER_SAD_OP + OPS_PER_OFFSET[1])
    elif wrapper in ("refine_launch", "esa_launch"):
        radius = a["refine"] if wrapper == "refine_launch" else a["me_range"]
        n, k = a["y_src"].numel() // 256, (2 * radius + 1) ** 2
        ops = n * k * (256 // PIXELS_PER_SAD_OP
                       + OPS_PER_OFFSET[9 if a["shapes"] else 1])
    else:
        lane_mv, masks, tab = a["lane_mv"], a["masks"], a["tab"]
        n, cands = a["y_src"].numel() // 256, tab.shape[0]
        _, pairs = subpel_pairs(lane_mv, masks)
        ops = pairs * (cands * OPS_PER_SATD_BLOCK
                       + 4 * OPS_PER_AVG_ROW * int((tab[:, 8] != 0).sum()))
        ops += n * cands * (int((masks != 0).sum())
                            + masks.shape[0] * OPS_PER_LANE_CAND)
    return nbytes, ops


class Meta:
    """Stands for a large tensor whose size alone a bound needs."""

    def __init__(self, t):
        self.shape, self._n, self._e = tuple(t.shape), t.numel(), \
            t.element_size()

    def numel(self):
        return self._n

    def element_size(self):
        return self._e


def light(x, limit=1 << 20):
    """What a bound keeps of an argument or output: small tensors cloned
    (they are read after the window), large ones as their sizes."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone() if x.numel() <= limit else Meta(x)
    if isinstance(x, dict):
        return {k: light(v, limit) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [light(v, limit) for v in x]
    return x


def _tensors(x):
    import torch
    if isinstance(x, (torch.Tensor, Meta)):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def bound_ms(wrapper: str, a: dict, out, rate) -> float:
    """Least milliseconds one launch of `wrapper` with bound arguments `a`
    and output `out` (light copies) can take at `rate` (from rates)."""
    if wrapper == "commit_launch":
        nbytes, ops = commit_work(a, out[0], out[1])
    elif wrapper == "deblock_launch":
        nbytes, ops = deblock_work(a)
    else:
        nbytes, ops = motion_work(wrapper, a, _tensors(out))
    return max(nbytes / rate[0], ops / rate[1]) * 1e3
