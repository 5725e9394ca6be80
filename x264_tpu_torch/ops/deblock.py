"""In-loop deblocking filter (spec 8.7; x264_tpu/ops/deblock.py).

Two versions of one function, with the outputs of x264_tpu's
`deblock_frame` (a jnp `lax.scan` over the MB anti-diagonals):

- `deblock_ref`, plain PyTorch, on any device. It filters groups of MBs
  in an order that reproduces the spec's raster MB order. Each MB has a
  V phase (its vertical edges) and an H phase (its horizontal edges).
  With `order="diagonal"` (the default, x264_tpu's schedule) a group is
  one anti-diagonal d = x + y, every MB's V phase first, then every MB's
  H phase: V(x, y) needs its left MB final (diagonal d-1); H(x, y) needs
  V(x, y) and its top MB, whose right neighbour (x+1, y-1) is on diagonal
  d and filters its left edge in the V phase. With `order="raster"` a
  group is one MB, in raster order: the schedule of the first CUDA
  kernel's MB rows. With `order="phased"` a group is one half-step of
  the CUDA kernel (`phased_steps`): at step s row y works on k = s - 2y,
  MB k // 2, in phase V if k is even and H if k is odd, so every MB of a
  step is in the same phase. Each phase gathers one region per MB of
  the group straight from raster planes (the regions of one phase do not
  overlap), filters it and scatters it back.
- the hand-written CUDA kernel in `csrc/deblock.cu` (the port of the
  scan): one persistent launch per frame whose blocks walk bands of
  `band_rows()` MB rows, one warp a row, in the phased schedule
  (`deblock_cuda`).

`deblock_frame(...)` dispatches on the planes' device: CPU tensors go to
`deblock_ref`, CUDA tensors to the kernel. `deblock_frame.launches` counts
kernel launches.

The strengths come from `intra_strengths` (I frames), `compute_strengths`
(P frames) or `compute_strengths_b` (B frames).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import const
from . import _cuda
from . import tables as T
from ._cuda import check_progress, check_tensor
from ..utils import trace
from .commit import _diag_mbs, n_diags

# spec tables 8-16 / 8-17 (qp 0..51), as in x264_tpu/ops/deblock.py (a JAX
# module, so copied)
ALPHA_TABLE = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255], dtype=np.int32)
BETA_TABLE = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)
TC0_TABLE = np.array(
    [[0, 0, 0]] * 17
    + [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
       [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
       [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
       [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
       [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
       [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
       [13, 17, 25]], dtype=np.int32)

_PAD = 4          # zero border so regions left of / above the frame index


def filter_lines_luma(p, q, bs, alpha, beta, tc0):
    """Filter luma lines across one edge. p [..., 4] = p3..p0, q [..., 4] =
    q0..q3; bs, alpha, beta, tc0 broadcastable per line. Returns (p, q)."""
    p = p.to(torch.int32)
    q = q.to(torch.int32)
    p3, p2, p1, p0 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    # normal filter (bs 1..3)
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = (p0 + delta).clamp(0, 255)
    nq0 = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    dp1 = torch.clamp((p2 + avg - (p1 << 1)) >> 1, -tc0, tc0)
    dq1 = torch.clamp((q2 + avg - (q1 << 1)) >> 1, -tc0, tc0)
    np1 = torch.where(ap, p1 + dp1, p1)
    nq1 = torch.where(aq, q1 + dq1, q1)
    # strong filter (bs == 4)
    cond = (p0 - q0).abs() < ((alpha >> 2) + 2)
    use_p = ap & cond
    s_p0 = torch.where(use_p, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s_p1 = torch.where(use_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s_p2 = torch.where(use_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    use_q = aq & cond
    s_q0 = torch.where(use_q, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s_q1 = torch.where(use_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    s_q2 = torch.where(use_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    strong = bs == 4
    out_p = torch.stack([
        p3,
        torch.where(filt, torch.where(strong, s_p2, p2), p2),
        torch.where(filt, torch.where(strong, s_p1, np1), p1),
        torch.where(filt, torch.where(strong, s_p0, np0), p0)], dim=-1)
    out_q = torch.stack([
        torch.where(filt, torch.where(strong, s_q0, nq0), q0),
        torch.where(filt, torch.where(strong, s_q1, nq1), q1),
        torch.where(filt, torch.where(strong, s_q2, q2), q2),
        q3], dim=-1)
    return out_p, out_q


def filter_lines_chroma(p, q, bs, alpha, beta, tc0):
    """Chroma: p [..., 2] = p1, p0; q [..., 2] = q0, q1."""
    p = p.to(torch.int32)
    q = q.to(torch.int32)
    p1, p0 = p.unbind(-1)
    q0, q1 = q.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    strong = bs == 4
    f_p0 = torch.where(strong, (2 * p1 + p0 + q1 + 2) >> 2,
                       (p0 + delta).clamp(0, 255))
    f_q0 = torch.where(strong, (2 * q1 + q0 + p1 + 2) >> 2,
                       (q0 - delta).clamp(0, 255))
    out_p = torch.stack([p1, torch.where(filt, f_p0, p0)], dim=-1)
    out_q = torch.stack([torch.where(filt, f_q0, q0), q1], dim=-1)
    return out_p, out_q


def _edge_params(qp_avg, a_off, b_off, bs):
    """alpha / beta / tc0 of an edge from its averaged qp."""
    dev = qp_avg.device
    ia = (qp_avg + a_off).clamp(0, 51).long()
    ib = (qp_avg + b_off).clamp(0, 51).long()
    alpha = const(ALPHA_TABLE, dev)[ia]
    beta = const(BETA_TABLE, dev)[ib]
    tc0 = const(TC0_TABLE.reshape(-1), dev)[ia * 3 + bs.clamp(1, 3) - 1]
    return alpha, beta, tc0


def intra_strengths(mbw: int, mbh: int, device):
    """All-intra boundary strengths (bs_v, bs_h) [mbh, mbw, 4 edges,
    4 lines]: 4 on MB edges, 3 inside."""
    bs = torch.full((mbh, mbw, 4, 4), 3, dtype=torch.int32, device=device)
    bs[:, :, 0, :] = 4
    return bs, bs


def _rep4(a):
    return a.repeat_interleave(4, 0).repeat_interleave(4, 1)


def _shift_in(a, dim):
    """a moved one step forward along `dim` (0 or 1), zero-filled: each
    4x4 block sees the block to its left (dim 1) or above (dim 0)."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([z, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def compute_strengths(intra_mb, nnz4, mv_mb, *, mbw, mbh, ref_mb=None):
    """Boundary strengths of a P frame (spec 8.7.2.1).

    intra_mb [mbh, mbw] bool; nnz4 [mbh*4, mbw*4] int; mv_mb [mbh, mbw, 2]
    MB-granular or [mbh*4, mbw*4, 2] 4x4-granular; ref_mb [mbh, mbw] the
    per-MB L0 refIdx (two references: blocks on different pictures get
    bs >= 1), or None. Returns (bs_v, bs_h) [mbh, mbw, 4 edges, 4 lines]."""
    ih, iw = mbh * 4, mbw * 4
    dev = nnz4.device
    intra4 = _rep4(intra_mb)
    mv4 = mv_mb if mv_mb.shape[0] == ih else _rep4(mv_mb)
    ref4 = None if ref_mb is None else _rep4(ref_mb)

    def edge_bs(dim):
        # p = the block one step back along dim, q = the block itself
        intra_p = _shift_in(intra4, dim)
        nnz_p = _shift_in(nnz4, dim)
        mv_p = _shift_in(mv4, dim)
        pos = torch.arange(iw if dim == 1 else ih, device=dev)
        mb_edge = (pos % 4 == 0)[None, :] if dim == 1 else \
            (pos % 4 == 0)[:, None]
        bs_intra = torch.where(mb_edge, 4, 3).expand(ih, iw)
        nz = (nnz4 > 0) | (nnz_p > 0)
        mv_diff = ((mv4 - mv_p).abs() >= 4).any(-1)
        if ref4 is not None:
            mv_diff = mv_diff | (ref4 != _shift_in(ref4, dim))
        bs_inter = torch.where(nz, 2, torch.where(mv_diff, 1, 0))
        return torch.where(intra4 | intra_p, bs_intra, bs_inter) \
            .to(torch.int32)

    bs_v = edge_bs(1).reshape(mbh, 4, mbw, 4).permute(0, 2, 3, 1)
    bs_h = edge_bs(0).reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)
    return bs_v.contiguous(), bs_h.contiguous()


def compute_strengths_b(nnz4, use0_mb, use1_mb, mv0_mb, mv1_mb, *, mbw, mbh):
    """Boundary strengths of a B frame of 16x16 partitions (spec 8.7.2.1,
    mixed prediction; x264_tpu ops/deblock.compute_strengths_b).

    use0 / use1 [mbh, mbw]: which lists the MB predicts from (explicit and
    direct MBs alike); mv0 / mv1 [mbh, mbw, 2]. bs 2 on an edge with
    coefficients; else 1 when the two blocks use different reference sets
    or a used list's |mv delta| >= 4; else 0 (the two references are
    different pictures, so no cross-list case arises)."""
    use04, use14 = _rep4(use0_mb), _rep4(use1_mb)
    mv04, mv14 = _rep4(mv0_mb), _rep4(mv1_mb)

    def edge_bs(dim):
        nz = (nnz4 > 0) | (_shift_in(nnz4, dim) > 0)
        diff_set = ((use04 != _shift_in(use04, dim))
                    | (use14 != _shift_in(use14, dim)))
        d0 = ((mv04 - _shift_in(mv04, dim)).abs() >= 4).any(-1)
        d1 = ((mv14 - _shift_in(mv14, dim)).abs() >= 4).any(-1)
        mv_diff = (use04 & d0) | (use14 & d1)
        return torch.where(nz, 2, torch.where(diff_set | mv_diff, 1, 0)) \
            .to(torch.int32)

    bs_v = edge_bs(1).reshape(mbh, 4, mbw, 4).permute(0, 2, 3, 1)
    bs_h = edge_bs(0).reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)
    return bs_v.contiguous(), bs_h.contiguous()


def _region(plane, r0, c0, h, w):
    """Index grids of [L, h, w] regions at (r0, c0) (padded coords)."""
    ar_h = torch.arange(h, device=plane.device)
    ar_w = torch.arange(w, device=plane.device)
    return r0[:, None, None] + ar_h[:, None], c0[:, None, None] + ar_w


def _filter_v(plane, r0, c0, rows, n_edges, step, width, bs_at, qp_at,
              a_off, b_off, fn):
    """Vertical edges of a diagonal's MBs: region [L, rows, width] starting
    `width - step*n_edges` columns left of the MB; edge e sits at column
    (width - step*n_edges) + step*e of the region."""
    ri, ci = _region(plane, r0, c0, rows, width)
    reg = plane[ri, ci]
    half = width - step * n_edges          # p-side width of edge 0
    for e in range(n_edges):
        c = half + step * e
        bs = bs_at(e)
        alpha, beta, tc0 = _edge_params(qp_at(e)[:, None], a_off, b_off, bs)
        p, q = fn(reg[:, :, c - half:c], reg[:, :, c:c + half], bs, alpha,
                  beta, tc0)
        reg = torch.cat([reg[:, :, :c - half], p, q, reg[:, :, c + half:]],
                        dim=2)
    plane[ri, ci] = reg


def phased_steps(mbw, mbh):
    """The CUDA kernel's schedule: 2 (mbw + mbh - 1) half-steps, each a
    list (phase, xs, ys) of the MBs that run it side by side. At step s
    row y works on k = s - 2y (0 <= k < 2 mbw): MB x = k // 2 in phase
    "v" if k is even, "h" if odd (k and s have the same parity). So
    V(x, y) runs beside V(x + 1, y - 1) (disjoint rows) and H(x, y) beside
    H(x + 1, y - 1) (disjoint columns), and H(x, y) one step after
    V(x + 1, y - 1), which rewrites the top MB's columns 13-15."""
    steps = []
    for s in range(2 * (mbw + mbh - 1)):
        ys = [y for y in range(mbh) if 0 <= s - 2 * y < 2 * mbw]
        steps.append(("vh"[s % 2], [(s - 2 * y) // 2 for y in ys], ys))
    return steps


def _mb_groups(order, mbw, mbh, device):
    """MB groups (phases, xs, ys) in filter order: anti-diagonals or
    single MBs in both phases ("vh"), or half-steps in one ("v" / "h")."""
    def tensors(xs, ys):
        return (torch.tensor(xs, device=device),
                torch.tensor(ys, device=device))

    if order == "diagonal":
        return (("vh", *_diag_mbs(d, mbw, mbh, device))
                for d in range(n_diags(mbw, mbh)))
    if order == "raster":
        return (("vh", *tensors([x], [y]))
                for y in range(mbh) for x in range(mbw))
    if order == "phased":
        return ((phase, *tensors(xs, ys))
                for phase, xs, ys in phased_steps(mbw, mbh))
    raise ValueError(f"order {order!r}: 'diagonal', 'raster' or 'phased'")


def deblock_ref(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0,
                b_off=0, chroma_qp_offset=0, order="diagonal"):
    """Plain PyTorch deblock of a frame: y [H, W], u/v [H/2, W/2] uint8;
    bs_v/bs_h [mbh, mbw, 4 edges, 4 lines]; qp_mb [mbh, mbw] the
    decoder-carried QPs. `order`: "diagonal", "raster" or "phased" (see
    the module note; all give the same planes). Returns filtered (y, u, v)
    uint8."""
    dev = y.device
    bs_v = bs_v.clone()
    bs_h = bs_h.clone()
    bs_v[:, 0, 0, :] = 0                    # picture left edge
    bs_h[0, :, 0, :] = 0                    # picture top edge
    qp_mb = qp_mb.to(torch.int32)
    cqp_mb = const(T.CHROMA_QP_TABLE, dev)[
        (qp_mb + chroma_qp_offset).clamp(0, 51).long()]

    def padded(p):
        out = torch.zeros((p.shape[0] + _PAD, p.shape[1] + _PAD),
                          dtype=torch.int32, device=dev)
        out[_PAD:, _PAD:] = p
        return out

    yp, up, vp = padded(y), padded(u), padded(v)
    for phases, xs, ys in _mb_groups(order, mbw, mbh, dev):
        if "v" in phases:
            _v_phase(yp, up, vp, xs, ys, bs_v[ys, xs], qp_mb, cqp_mb,
                     a_off, b_off)
        if "h" in phases:
            _h_phase(yp, up, vp, xs, ys, bs_h[ys, xs], qp_mb, cqp_mb,
                     a_off, b_off)
    return tuple(p[_PAD:, _PAD:].to(torch.uint8) for p in (yp, up, vp))


def _v_phase(yp, up, vp, xs, ys, bsv, qp_mb, cqp_mb, a_off, b_off):
    """The V phase of MBs (xs, ys) on the padded planes, in place: the
    vertical luma edges left to right, then chroma edges 0 and 4 (from
    luma edges 0 and 2). bsv [L, 4 edges, 4 lines]."""
    q_cur = qp_mb[ys, xs]
    q_left = qp_mb[ys, (xs - 1).clamp(min=0)]
    cq_cur = cqp_mb[ys, xs]
    cq_left = cqp_mb[ys, (xs - 1).clamp(min=0)]
    _filter_v(yp, ys * 16 + _PAD, xs * 16, 16, 4, 4, 20,
              lambda e: bsv[:, e].repeat_interleave(4, 1),
              lambda e: ((q_left if e == 0 else q_cur) + q_cur + 1) >> 1,
              a_off, b_off, filter_lines_luma)
    for cp in (up, vp):
        _filter_v(cp, ys * 8 + _PAD, xs * 8 + _PAD - 2, 8, 2, 4, 10,
                  lambda e: bsv[:, 2 * e].repeat_interleave(2, 1),
                  lambda e: (((cq_left if e == 0 else cq_cur) + cq_cur + 1)
                             >> 1),
                  a_off, b_off, filter_lines_chroma)


def _h_phase(yp, up, vp, xs, ys, bsh, qp_mb, cqp_mb, a_off, b_off):
    """The H phase of MBs (xs, ys), in place: the horizontal edges top to
    bottom, as vertical edges of the transposed planes."""
    q_cur = qp_mb[ys, xs]
    q_top = qp_mb[(ys - 1).clamp(min=0), xs]
    cq_cur = cqp_mb[ys, xs]
    cq_top = cqp_mb[(ys - 1).clamp(min=0), xs]
    _filter_v(yp.t(), xs * 16 + _PAD, ys * 16, 16, 4, 4, 20,
              lambda e: bsh[:, e].repeat_interleave(4, 1),
              lambda e: (q_top + q_cur + 1) >> 1 if e == 0 else q_cur,
              a_off, b_off, filter_lines_luma)
    for cp in (up, vp):
        _filter_v(cp.t(), xs * 8 + _PAD, ys * 8 + _PAD - 2, 8, 2, 4, 10,
                  lambda e: bsh[:, 2 * e].repeat_interleave(2, 1),
                  lambda e: (cq_top + cq_cur + 1) >> 1 if e == 0
                  else cq_cur,
                  a_off, b_off, filter_lines_chroma)


# ------------------------------------------------------------- CUDA kernel
_LIB = {}


class _DeblockArgs(ctypes.Structure):
    """Mirror of `struct DeblockArgs` in csrc/deblock.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "y", "u", "v", "dy", "du", "dv", "bs_v", "bs_h", "qp")] + [
        (name, ctypes.c_int32) for name in (
            "mbw", "mbh", "a_off", "b_off", "cqpo")]


def _library():
    if "lib" not in _LIB:
        lib = _cuda.library()
        launch = [ctypes.POINTER(_DeblockArgs), ctypes.c_void_p, ctypes.c_int]
        for name, extra in (("frame", []), ("frame_rows", [ctypes.c_int]),
                            ("frame_rowwarp", [])):
            fn = getattr(lib, f"x264t_deblock_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = launch + extra + [ctypes.c_void_p]
        for name in ("rows", "args_size"):
            fn = getattr(lib, f"x264t_deblock_{name}")
            fn.restype, fn.argtypes = ctypes.c_int, []
        if lib.x264t_deblock_args_size() != ctypes.sizeof(_DeblockArgs):
            raise RuntimeError("DeblockArgs layout differs between "
                               "deblock.cu and its binding")
        _LIB["lib"] = lib
    return _LIB["lib"]


def band_rows() -> int:
    """MB rows per block of the deblock kernel (kRows in deblock.cu)."""
    return _library().x264t_deblock_rows()


def grid_capacity(device) -> int:
    """Blocks of the deblock kernel that `device` holds at once."""
    return _cuda.capacity("deblock", device)


def _prepare(y, u, v, bs_v, bs_h, qp_mb, mbw, mbh, a_off, b_off,
             chroma_qp_offset):
    """Check a launch's inputs and allocate its outputs and progress
    words. Returns (args, outputs, prog, qp): qp is the int32 QP map the
    args point at, held until the launch is queued."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"deblock_cuda takes CUDA tensors, got {dev}")
    H, W = 16 * mbh, 16 * mbw
    check_tensor(y, "y", (H, W), torch.uint8, dev)
    check_tensor(u, "u", (H // 2, W // 2), torch.uint8, dev)
    check_tensor(v, "v", (H // 2, W // 2), torch.uint8, dev)
    check_tensor(bs_v, "bs_v", (mbh, mbw, 4, 4), torch.int32, dev)
    check_tensor(bs_h, "bs_h", (mbh, mbw, 4, 4), torch.int32, dev)
    if qp_mb.device != dev or tuple(qp_mb.shape) != (mbh, mbw) \
            or qp_mb.dtype.is_floating_point:
        raise ValueError(f"qp_mb: expected integer [{mbh}, {mbw}] on {dev}")
    # a converted qp is freed on return: PyTorch's caching allocator hands
    # its memory only to work queued after this launch on the same stream
    qp = qp_mb.to(torch.int32).contiguous()
    # the kernel reads the planes' rows and each MB's 16 strength words in
    # 16-byte copies
    if any(t.data_ptr() % 16 for t in (y, u, v, bs_v, bs_h)):
        raise ValueError("planes and strengths must be 16-byte aligned")
    out = tuple(torch.empty_like(t) for t in (y, u, v))
    args = _DeblockArgs(*(t.data_ptr() for t in (y, u, v, *out, bs_v, bs_h,
                                                  qp)),
                        mbw, mbh, a_off, b_off, chroma_qp_offset)
    prog = torch.zeros(mbh + 1, dtype=torch.int32, device=dev)
    return args, out, prog, qp


def _launched(rc):
    if rc != 0:
        raise RuntimeError(f"deblock kernel launch failed: CUDA error {rc}")


def deblock_launch(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0,
                   b_off=0, chroma_qp_offset=0, grid=None):
    """One launch of the deblock kernel on the current stream, without
    waiting for it. Inputs as deblock_ref's, on one CUDA device: uint8
    planes and int32 strengths, contiguous and 16-byte aligned; qp_mb of
    any integer type (taken as int32, as deblock_ref takes it). The
    outputs are new planes; the inputs are left as they are. Returns
    ((y, u, v), prog): `prog` holds each MB row's progress and, last, the
    error word; `check_launch(prog, mbw)` reads it once the launch is
    done. `grid` caps the persistent blocks, each a band of band_rows()
    MB rows (default: one per band, as many as the card holds at once)."""
    args, out, prog, _qp = _prepare(y, u, v, bs_v, bs_h, qp_mb, mbw, mbh,
                                    a_off, b_off, chroma_qp_offset)
    bands = -(-mbh // band_rows())
    cap = min(bands, grid_capacity(y.device))
    grid = cap if grid is None else grid
    if not 1 <= grid <= cap:
        raise ValueError(f"grid {grid} outside 1..{cap}")
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _launched(_library().x264t_deblock_frame(ctypes.byref(args),
                                             prog.data_ptr(), grid, stream))
    deblock_frame.launches += 1
    return out, prog


def check_launch(prog, mbw, rowwarp=False):
    """Raise unless the launch that filled `prog` finished every row (2 mbw
    half-steps; mbw MBs for deblock_launch_rowwarp). Synchronises."""
    check_progress(prog, mbw if rowwarp else 2 * mbw)


def deblock_launch_rows(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, rows,
                        a_off=0, b_off=0, chroma_qp_offset=0):
    """The deblock kernel with `rows` (1, 2, 4 or 8) MB rows per block, one
    block per band: off the main path, so that a run on the card can time
    the band heights side by side. As deblock_launch otherwise."""
    args, out, prog, _qp = _prepare(y, u, v, bs_v, bs_h, qp_mb, mbw, mbh,
                                    a_off, b_off, chroma_qp_offset)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _launched(_library().x264t_deblock_frame_rows(
        ctypes.byref(args), prog.data_ptr(), -(-mbh // rows), rows, stream))
    return out, prog


def deblock_launch_rowwarp(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0,
                           b_off=0, chroma_qp_offset=0):
    """The first port's deblock kernel (deblock_frame_kernel_rowwarp: one
    warp per MB row, a progress count per whole MB through global memory),
    one block per row: off the main path, kept so that a run on the card
    can time the two designs on the same inputs."""
    args, out, prog, _qp = _prepare(y, u, v, bs_v, bs_h, qp_mb, mbw, mbh,
                                    a_off, b_off, chroma_qp_offset)
    grid = min(mbh, _cuda.capacity("deblock_rowwarp", y.device))
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _launched(_library().x264t_deblock_frame_rowwarp(
        ctypes.byref(args), prog.data_ptr(), grid, stream))
    return out, prog


def deblock_cuda(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0, b_off=0,
                 chroma_qp_offset=0, grid=None):
    """The CUDA deblock kernel (csrc/deblock.cu deblock_frame_kernel): one
    launch per frame on the current stream, then one read-back of its
    progress words that checks it finished (as commit_cuda does: one
    host synchronisation per launch). Returns the filtered (y, u, v)."""
    out, prog = deblock_launch(y, u, v, bs_v, bs_h, qp_mb, mbw=mbw, mbh=mbh,
                               a_off=a_off, b_off=b_off,
                               chroma_qp_offset=chroma_qp_offset, grid=grid)
    check_launch(prog, mbw)
    return out


@trace.spanned("analysis:deblock")
def deblock_frame(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0,
                  b_off=0, chroma_qp_offset=0):
    """Deblock a frame, with the outputs of x264_tpu's deblock_frame: y
    [H, W], u/v [H/2, W/2] uint8; bs_v/bs_h [mbh, mbw, 4 edges, 4 lines];
    qp_mb [mbh, mbw] the decoder-carried QPs. CUDA tensors go to the
    kernel (one launch), CPU tensors to deblock_ref. Returns new filtered
    (y, u, v) uint8 planes; `deblock_frame.launches` counts the kernel's
    launches."""
    fn = deblock_cuda if y.is_cuda else deblock_ref
    return fn(y, u, v, bs_v, bs_h, qp_mb, mbw=mbw, mbh=mbh, a_off=a_off,
              b_off=b_off, chroma_qp_offset=chroma_qp_offset)


deblock_frame.launches = 0
