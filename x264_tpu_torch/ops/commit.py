"""Wavefront intra commit: exact reconstruction along MB anti-diagonals.

Two versions of one function, with the outputs of x264_tpu's
`intra.commit_dispatch`:

- `commit_ref`, plain PyTorch: a twin of `intra._commit_scan` that walks
  the D = mbw + mbh - 1 anti-diagonals and indexes each diagonal's MBs
  directly in raster planes. It runs on any device.
- the hand-written CUDA kernel in `csrc/commit.cu` (the port of the Pallas
  kernel `x264_tpu/ops/pallas/commit.py::commit_i16_pallas`): one
  persistent launch per frame whose blocks walk MB rows and wait on the
  row above (`commit_cuda`).

Both take one frame (planes [H, W], maps [mbh, mbw]) or a batch of B
items of one shape along a leading axis (planes [B, H, W], maps
[B, mbh, mbw]): the frames of B streams, or the slice bands of frames,
each committed as a frame of its own. A batch is one kernel launch
(`commit_ref` loops over its items); `commit_batch` stacks per-item calls.

`commit(...)` dispatches on the input tensors' device: CPU tensors go to
`commit_ref`, CUDA tensors to the kernel. `commit.launches` counts kernel
launches. `commit_cuda_diag` keeps the first port's one-launch-per-diagonal
kernel, off the main path, for timing the two side by side.

Every unavailable neighbour pixel reads as 0, which is what the JAX scan's
zero-initialised skewed planes give; valid modes never read one anyway.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..device import const
from . import _cuda, dct, predict, quant, tables
# the build and the progress check, for callers of this module
from ._cuda import build_library, check_progress  # noqa: F401
from ._cuda import check_tensor
from ..utils import trace

# z-scan coding order of the 16 luma 4x4 blocks (spec figure 6-10)
I4_ZX = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
I4_ZY = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
# raster blocks (bx + 4 by) in the frame kernel's order: a wavefront over
# s = bx + 2 by, whose blocks of one step depend only on earlier steps
I4_WAVEFRONT = sorted(range(16), key=lambda r: ((r & 3) + 2 * (r >> 2), r))
# in-MB blocks whose above-right 4x4 neighbour is unavailable per the
# z-scan decoding-order rule (spec 6.4.12.3): raster (bx, by) pairs
_I4_TR_UNAVAIL_INMB = {(1, 1), (3, 1), (3, 2), (1, 3), (3, 3)}


def _i4_block_avail(bx, by):
    """Static availability kind of block (bx, by)'s above-right neighbour:
    'real' (in-MB or above-MB, always decoded), 'lane' (depends on the
    MB's above availability), 'none' (substituted t[3] per 8.3.1.2).
    Block (3, 0)'s above-right lives in the above-right MB, which shares
    the wavefront diagonal: it counts as 'none', and the decision bans
    modes DDL and VL there."""
    if by == 0:
        return "none" if bx == 3 else "lane"
    return "none" if (bx, by) in _I4_TR_UNAVAIL_INMB else "real"


_I4_KIND = np.array([{"none": 0, "lane": 1, "real": 2}[
    _i4_block_avail(r % 4, r // 4)] for r in range(16)], np.int32)


# ------------------------------------------------------------ block layout
def _luma_blocks(mb):
    """[L, 16, 16] -> [L, 16, 4, 4] raster 4x4 blocks."""
    L = mb.shape[0]
    return mb.reshape(L, 4, 4, 4, 4).transpose(2, 3).reshape(L, 16, 4, 4)


def _luma_merge(blocks):
    L = blocks.shape[0]
    return blocks.reshape(L, 4, 4, 4, 4).transpose(2, 3).reshape(L, 16, 16)


def _chroma_blocks(mb):
    L = mb.shape[0]
    return mb.reshape(L, 2, 4, 2, 4).transpose(2, 3).reshape(L, 4, 4, 4)


def _chroma_merge(blocks):
    L = blocks.shape[0]
    return blocks.reshape(L, 2, 2, 4, 4).transpose(2, 3).reshape(L, 8, 8)


def _pick(preds, mode):
    """preds [L, M, s, s], mode [L] -> preds[l, mode[l]]."""
    idx = mode.long().clamp(0, preds.shape[1] - 1)
    return preds[torch.arange(preds.shape[0], device=preds.device), idx]


# --------------------------------------------------------- transform paths
def _encode_luma_i16(src, pred, qp):
    """I16x16 luma for [L] MBs -> (dc_lv [L,4,4], ac_lv [L,16,4,4] with
    position 0 zeroed, recon [L,16,16])."""
    res = src.to(torch.int32) - pred
    w = dct.dct4x4(_luma_blocks(res))
    had = dct.dct4x4dc(w[:, :, 0, 0].reshape(-1, 4, 4))
    dc_lv = quant.quant4x4_dc(had, qp)
    ac_lv = quant.quant4x4(w, qp[:, None], True)
    ac_lv[:, :, 0, 0] = 0
    dc_vals = quant.dequant4x4_dc(dct.ihadamard4x4(dc_lv), qp)
    d = quant.dequant4x4(ac_lv, qp[:, None])
    d[:, :, 0, 0] = dc_vals.reshape(-1, 16)
    recon = (pred + _luma_merge(dct.idct4x4(d))).clamp(0, 255)
    return dc_lv, ac_lv, recon


def _encode_chroma_i8(src, pred, qpc):
    """One chroma component's 8x8 -> (dc_lv [L,2,2], ac_lv [L,4,4,4] with
    position 0 zeroed, recon [L,8,8])."""
    res = src.to(torch.int32) - pred
    w = dct.dct4x4(_chroma_blocks(res))
    had = dct.hadamard2x2(w[:, :, 0, 0].reshape(-1, 2, 2))
    dc_lv = quant.quant2x2_dc(had, qpc, True)
    ac_lv = quant.quant4x4(w, qpc[:, None], True)
    ac_lv[:, :, 0, 0] = 0
    dc_vals = quant.dequant2x2_dc(dct.ihadamard2x2(dc_lv), qpc)
    d = quant.dequant4x4(ac_lv, qpc[:, None])
    d[:, :, 0, 0] = dc_vals.reshape(-1, 4)
    recon = (pred + _chroma_merge(dct.idct4x4(d))).clamp(0, 255)
    return dc_lv, ac_lv, recon


def _i4_commit_mb(src, left16, top16, tl_mb, al, at, modes16, qp,
                  order=None):
    """Exact I_4x4 reconstruction of [L] MBs: 16 sequential block steps
    on an edge buffer ext [L, 17, 21] (row 0 = tl + top16 + 4 spill
    columns, column 0 = tl + left16, interior = progressive recon).
    `order` lists the raster blocks (bx + 4 by) in the order they are
    committed; z-scan by default. Any order that puts each block after
    its left, top, top-left and top-right neighbours gives the same bits
    (I4_WAVEFRONT is the frame kernel's).
    Returns (lv [L,16,4,4] raster full 16-coeff blocks, recon [L,16,16])."""
    L = src.shape[0]
    dev = src.device
    ext = torch.zeros((L, 17, 21), dtype=torch.int32, device=dev)
    ext[:, 0, 0] = tl_mb
    ext[:, 0, 1:17] = top16
    ext[:, 0, 17:21] = top16[:, 15:16]
    ext[:, 1:17, 0] = left16
    lv_all = torch.zeros((L, 16, 4, 4), dtype=torch.int32, device=dev)
    src = src.to(torch.int32)
    ones = torch.ones_like(al)
    if order is None:
        order = [int(y) * 4 + int(x) for x, y in zip(I4_ZX, I4_ZY)]
    for r in order:
        bx, by = r % 4, r // 4
        c4, r4 = bx * 4, by * 4
        left4 = ext[:, r4 + 1:r4 + 5, c4]
        top8r = ext[:, r4, c4 + 1:c4 + 9]
        tl = ext[:, r4, c4]
        kind = _I4_KIND[r]
        tr_ok = ones if kind == 2 else (at if kind == 1 else ~ones)
        top8 = torch.cat([top8r[:, :4], torch.where(
            tr_ok[:, None], top8r[:, 4:], top8r[:, 3:4])], dim=-1)
        al_b = ones if bx > 0 else al
        at_b = ones if by > 0 else at
        preds = predict.predict_4x4_all(left4, top8, tl, al_b, at_b)
        pred = _pick(preds, modes16[:, r])
        res = src[:, r4:r4 + 4, c4:c4 + 4] - pred
        lv = quant.quant4x4(dct.dct4x4(res), qp, True)
        d = quant.dequant4x4(lv, qp)
        ext[:, r4 + 1:r4 + 5, c4 + 1:c4 + 5] = (
            pred + dct.idct4x4(d)).clamp(0, 255)
        lv_all[:, r] = lv
    return lv_all, ext[:, 1:17, 1:17]


# ------------------------------------------------------------ plain version
def n_diags(mbw: int, mbh: int) -> int:
    return mbw + mbh - 1


def _diag_mbs(d, mbw, mbh, device):
    """MB coordinates (xs, ys) on anti-diagonal d, ordered by row."""
    ys = torch.arange(max(0, d - mbw + 1), min(mbh - 1, d) + 1,
                      device=device)
    return d - ys, ys


def _edges(rec, xs, ys, s):
    """top [L, s], left [L, s], tl [L] of MBs (xs, ys) from a recon plane
    padded by one zero row on top and one zero column on the left."""
    ar = torch.arange(s, device=rec.device)
    r0, c0 = ys * s, xs * s
    top = rec[r0[:, None], c0[:, None] + 1 + ar]
    left = rec[r0[:, None] + 1 + ar, c0[:, None]]
    return top, left, rec[r0, c0]


def _tiles(plane, xs, ys, s):
    """[L, s, s] tiles of MBs (xs, ys) of an unpadded plane."""
    ar = torch.arange(s, device=plane.device)
    return plane[(ys * s)[:, None, None] + ar[:, None],
                 (xs * s)[:, None, None] + ar]


def _put(rec, xs, ys, s, vals):
    """Write [L, s, s] tiles into a plane padded as in _edges."""
    ar = torch.arange(s, device=rec.device)
    rec[(ys * s + 1)[:, None, None] + ar[:, None],
        (xs * s + 1)[:, None, None] + ar] = vals


def _items(fn, y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
           is_intra, inter_planes, i4_mask, i4_modes, **kw):
    """fn over the items of a batch (leading axis), outputs stacked."""
    outs, recons = [], []
    for b in range(y.shape[0]):
        def at(t):
            return None if t is None else t[b]
        out, recon = fn(
            y[b], u[b], v[b], i16_mode[b], chroma_mode[b], qp_mb[b],
            qpc_mb[b], mbw, mbh, is_intra=at(is_intra),
            inter_planes=(None if inter_planes is None
                          else tuple(p[b] for p in inter_planes)),
            i4_mask=at(i4_mask), i4_modes=at(i4_modes), **kw)
        outs.append(out)
        recons.append(recon)
    return ({k: torch.stack([o[k] for o in outs]) for k in outs[0]},
            tuple(torch.stack(r) for r in zip(*recons)))


def commit_ref(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
               is_intra=None, inter_planes=None, i4_mask=None,
               i4_modes=None, order=None):
    """Plain PyTorch twin of intra._commit_scan (bit-identical).
    With a leading item axis on every input (a batch), a loop over the
    items, outputs stacked along the same axis.

    y [H, W], u/v [H/2, W/2] uint8; i16_mode, chroma_mode, qp_mb, qpc_mb
    [mbh, mbw] int; optional i4_mask [mbh, mbw] + i4_modes [mbh, mbw, 16]
    (I_4x4 lanes: levels in "ac", dc = 0); optional is_intra [mbh, mbw] +
    inter_planes (y, u, v) (mixed intra-in-P: non-intra MBs copy the inter
    reconstruction and carry zero levels). `order`, optional, lists the MB
    groups (xs, ys) in commit order; each MB's left, top and top-left
    neighbours must lie in earlier groups. Default: the anti-diagonals.
    Returns (coeff dict of raster [N, ...] int32 tensors, recon planes)."""
    if y.dim() == 3:
        return _items(commit_ref, y, u, v, i16_mode, chroma_mode, qp_mb,
                      qpc_mb, mbw, mbh, is_intra, inter_planes, i4_mask,
                      i4_modes, order=order)
    dev = y.device
    H, W = y.shape
    n = mbw * mbh
    i32 = dict(dtype=torch.int32, device=dev)
    ry = torch.zeros((H + 1, W + 1), **i32)
    rc = [torch.zeros((H // 2 + 1, W // 2 + 1), **i32) for _ in range(2)]
    src_c = (u, v)
    out = {"dc": torch.zeros((n, 4, 4), **i32),
           "ac": torch.zeros((n, 16, 4, 4), **i32),
           "udc": torch.zeros((n, 2, 2), **i32),
           "uac": torch.zeros((n, 4, 4, 4), **i32),
           "vdc": torch.zeros((n, 2, 2), **i32),
           "vac": torch.zeros((n, 4, 4, 4), **i32)}
    mixed = is_intra is not None
    with_i4 = i4_mask is not None
    if order is None:
        order = (_diag_mbs(d, mbw, mbh, dev)
                 for d in range(n_diags(mbw, mbh)))
    for xs, ys in order:
        al, at = xs > 0, ys > 0
        idx = ys * mbw + xs
        qp = qp_mb[ys, xs].to(torch.int32)
        qpc = qpc_mb[ys, xs].to(torch.int32)

        # ---- luma ----
        top, left, tl = _edges(ry, xs, ys, 16)
        src = _tiles(y, xs, ys, 16).to(torch.int32)
        pred = _pick(predict.predict_16x16_all(left, top, tl, al, at),
                     i16_mode[ys, xs])
        dc_lv, ac_lv, recon = _encode_luma_i16(src, pred, qp)
        if with_i4:
            i4lane = i4_mask[ys, xs].bool()
            lv4, rec4 = _i4_commit_mb(src, left, top, tl, al, at,
                                      i4_modes[ys, xs], qp)
            recon = torch.where(i4lane[:, None, None], rec4, recon)
            ac_lv = torch.where(i4lane[:, None, None, None], lv4, ac_lv)
            dc_lv = torch.where(i4lane[:, None, None], 0, dc_lv)
        if mixed:
            ilane = is_intra[ys, xs].bool()
            recon = torch.where(ilane[:, None, None], recon,
                                _tiles(inter_planes[0], xs, ys, 16)
                                .to(torch.int32))
            dc_lv = torch.where(ilane[:, None, None], dc_lv, 0)
            ac_lv = torch.where(ilane[:, None, None, None], ac_lv, 0)
        _put(ry, xs, ys, 16, recon)
        out["dc"][idx] = dc_lv
        out["ac"][idx] = ac_lv

        # ---- chroma ----
        for c, name in enumerate("uv"):
            ctop, cleft, ctl = _edges(rc[c], xs, ys, 8)
            cpred = _pick(predict.predict_chroma_all(cleft, ctop, ctl, al, at),
                          chroma_mode[ys, xs])
            cdc, cac, crec = _encode_chroma_i8(
                _tiles(src_c[c], xs, ys, 8), cpred, qpc)
            if mixed:
                crec = torch.where(ilane[:, None, None], crec,
                                   _tiles(inter_planes[1 + c], xs, ys, 8)
                                   .to(torch.int32))
                cdc = torch.where(ilane[:, None, None], cdc, 0)
                cac = torch.where(ilane[:, None, None, None], cac, 0)
            _put(rc[c], xs, ys, 8, crec)
            out[name + "dc"][idx] = cdc
            out[name + "ac"][idx] = cac
    recon = (ry[1:, 1:].to(torch.uint8), rc[0][1:, 1:].to(torch.uint8),
             rc[1][1:, 1:].to(torch.uint8))
    return out, recon


# ------------------------------------------------------------- CUDA kernel
_LIB = {}
_LIB_LOCK = threading.Lock()


class _CommitArgs(ctypes.Structure):
    """Mirror of `struct CommitArgs` in csrc/commit.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "y", "u", "v", "i16_mode", "chroma_mode", "qp", "qpc", "i4_mask",
        "i4_modes", "is_intra", "iy", "iu", "iv", "tab", "ry", "ru", "rv",
        "dc", "ac", "udc", "uac", "vdc", "vac")] + [
        (name, ctypes.c_int64) for name in (
            "s_luma", "s_chroma", "s_map", "s_i4m", "s_dc", "s_ac", "s_cdc",
            "s_cac")] + [
        ("mbw", ctypes.c_int32), ("mbh", ctypes.c_int32),
        ("items", ctypes.c_int32)]


def _library():
    with _LIB_LOCK:
        if "lib" not in _LIB:
            lib = _cuda.library()
            args_p = ctypes.POINTER(_CommitArgs)
            lib.x264t_commit_frame.restype = ctypes.c_int
            lib.x264t_commit_frame.argtypes = [
                args_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.x264t_commit_diag.restype = ctypes.c_int
            lib.x264t_commit_diag.argtypes = [args_p, ctypes.c_int,
                                              ctypes.c_void_p]
            lib.x264t_empty_launch.restype = ctypes.c_int
            lib.x264t_empty_launch.argtypes = [ctypes.c_void_p]
            lib.x264t_commit_args_size.restype = ctypes.c_int
            lib.x264t_commit_args_size.argtypes = []
            if lib.x264t_commit_args_size() != ctypes.sizeof(_CommitArgs):
                raise RuntimeError("CommitArgs layout differs between "
                                   "commit.cu and its binding")
            _LIB["lib"] = lib
        return _LIB["lib"]


def grid_capacity(device) -> int:
    """Blocks of the frame kernel that `device` holds at once."""
    return _cuda.capacity("commit", device)


def _quant_tables(device):
    """Packed int32 table for the kernel: QUANT4_MF [6,16], DEQUANT4_MF
    [6,16], QUANT4_SCALE[:,0] [6], DEQUANT4_SCALE[:,0] [6]."""
    tab = np.concatenate([
        tables.QUANT4_MF.reshape(-1), tables.DEQUANT4_MF.reshape(-1),
        tables.QUANT4_SCALE[:, 0], tables.DEQUANT4_SCALE[:, 0]])
    return const(tab, device)


def _kernel_args(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
                 is_intra=None, inter_planes=None, i4_mask=None,
                 i4_modes=None):
    """Check the inputs of a batch (leading item axis B on every input),
    allocate the outputs and fill the CommitArgs struct. Returns (args,
    out, recon, tab); keep `tab` alive until the launches that read it are
    done."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"commit_cuda takes CUDA tensors, got {dev}")
    if y.dim() != 3 or y.shape[0] < 1:
        raise ValueError(f"y: expected [B, H, W], got {tuple(y.shape)}")
    B, H, W = y.shape[0], 16 * mbh, 16 * mbw
    u8, i32 = torch.uint8, torch.int32
    check_tensor(y, "y", (B, H, W), u8, dev)
    check_tensor(u, "u", (B, H // 2, W // 2), u8, dev)
    check_tensor(v, "v", (B, H // 2, W // 2), u8, dev)
    for name, t in (("i16_mode", i16_mode), ("chroma_mode", chroma_mode),
                    ("qp_mb", qp_mb), ("qpc_mb", qpc_mb)):
        check_tensor(t, name, (B, mbh, mbw), i32, dev)
    if (i4_mask is None) != (i4_modes is None):
        raise ValueError("i4_mask and i4_modes go together")
    if (is_intra is None) != (inter_planes is None):
        raise ValueError("is_intra and inter_planes go together")
    if i4_mask is not None:
        check_tensor(i4_mask, "i4_mask", (B, mbh, mbw), torch.bool, dev)
        check_tensor(i4_modes, "i4_modes", (B, mbh, mbw, 16), i32, dev)
    if is_intra is not None:
        check_tensor(is_intra, "is_intra", (B, mbh, mbw), torch.bool, dev)
        check_tensor(inter_planes[0], "inter y", (B, H, W), u8, dev)
        check_tensor(inter_planes[1], "inter u", (B, H // 2, W // 2), u8, dev)
        check_tensor(inter_planes[2], "inter v", (B, H // 2, W // 2), u8, dev)
    # the frame kernel copies tiles of these with cp.async (of a mask, the
    # aligned 4-byte word holding an MB's byte: at most 3 bytes past the
    # mask's end, inside its allocation, which PyTorch rounds up to 512)
    for t in (y, u, v, i4_modes, i4_mask, is_intra, *(inter_planes or ())):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("planes, masks and i4_modes must be 16-byte "
                             "aligned")
    n = mbw * mbh
    out = {"dc": torch.empty((B, n, 4, 4), dtype=i32, device=dev),
           "ac": torch.empty((B, n, 16, 4, 4), dtype=i32, device=dev),
           "udc": torch.empty((B, n, 2, 2), dtype=i32, device=dev),
           "uac": torch.empty((B, n, 4, 4, 4), dtype=i32, device=dev),
           "vdc": torch.empty((B, n, 2, 2), dtype=i32, device=dev),
           "vac": torch.empty((B, n, 4, 4, 4), dtype=i32, device=dev)}
    recon = tuple(torch.empty_like(p) for p in (y, u, v))
    tab = _quant_tables(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    inter = inter_planes if inter_planes is not None else (None,) * 3
    args = _CommitArgs(
        ptr(y), ptr(u), ptr(v), ptr(i16_mode), ptr(chroma_mode), ptr(qp_mb),
        ptr(qpc_mb), ptr(i4_mask), ptr(i4_modes), ptr(is_intra),
        ptr(inter[0]), ptr(inter[1]), ptr(inter[2]), ptr(tab),
        ptr(recon[0]), ptr(recon[1]), ptr(recon[2]), ptr(out["dc"]),
        ptr(out["ac"]), ptr(out["udc"]), ptr(out["uac"]), ptr(out["vdc"]),
        ptr(out["vac"]), y.stride(0), u.stride(0), qp_mb.stride(0),
        16 * qp_mb.stride(0), out["dc"].stride(0), out["ac"].stride(0),
        out["udc"].stride(0), out["uac"].stride(0), mbw, mbh, B)
    return args, out, recon, tab


def _as_batch(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, is_intra,
              inter_planes, i4_mask, i4_modes):
    """One frame's inputs as a batch of one (views, no copies)."""
    def one(t):
        return None if t is None else t.unsqueeze(0)
    return ([one(t) for t in (y, u, v, i16_mode, chroma_mode, qp_mb,
                              qpc_mb)],
            dict(is_intra=one(is_intra), i4_mask=one(i4_mask),
                 i4_modes=one(i4_modes),
                 inter_planes=(None if inter_planes is None
                               else tuple(one(p) for p in inter_planes))))


def _first_item(out, recon):
    return {k: t[0] for k, t in out.items()}, tuple(r[0] for r in recon)


# per block, as commit_frame_kernel writes them (csrc/commit.cu kStats)
STATS_FIELDS = ("wait_cycles", "i16_luma_cycles", "i4_luma_cycles",
                "chroma_cycles", "poll_cycles", "mbs", "i4_mbs",
                "run_cycles", "run_ns")


def commit_launch(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
                  is_intra=None, inter_planes=None, i4_mask=None,
                  i4_modes=None, grid=None, stats=None):
    """One launch of the frame kernel on the current stream, without
    waiting for it, for one frame or a batch (leading item axis on every
    input; the outputs then carry it too). Returns (out, recon, prog):
    `prog` holds each global row's finished-MB count (B * mbh of them)
    and, last, the error word; `check_progress(prog, mbw)` reads it once
    the launch is done. `grid` caps the persistent blocks (default
    min(B * mbh, what the card holds at once)). `stats`, zeros of shape
    (grid, len(STATS_FIELDS)) int64 on the card, receives each block's
    counters (STATS_FIELDS)."""
    single = y.dim() == 2
    if single:
        (y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb), kw = _as_batch(
            y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, is_intra,
            inter_planes, i4_mask, i4_modes)
        is_intra, inter_planes = kw["is_intra"], kw["inter_planes"]
        i4_mask, i4_modes = kw["i4_mask"], kw["i4_modes"]
    args, out, recon, _tab = _kernel_args(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
        is_intra=is_intra, inter_planes=inter_planes, i4_mask=i4_mask,
        i4_modes=i4_modes)
    rows = y.shape[0] * mbh
    cap = min(rows, grid_capacity(y.device))
    grid = cap if grid is None else grid
    if not 1 <= grid <= cap:
        raise ValueError(f"grid {grid} outside 1..{cap}")
    if stats is not None:
        check_tensor(stats, "stats", (grid, len(STATS_FIELDS)), torch.int64,
               y.device)
    prog = torch.zeros(rows + 1, dtype=torch.int32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _library().x264t_commit_frame(
        ctypes.byref(args), prog.data_ptr(), grid,
        None if stats is None else stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"commit kernel launch failed: CUDA error {rc}")
    commit.launches += 1
    if single:
        out, recon = _first_item(out, recon)
    return out, recon, prog


def commit_cuda(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
                is_intra=None, inter_planes=None, i4_mask=None,
                i4_modes=None, grid=None):
    """The CUDA frame kernel (csrc/commit.cu commit_frame_kernel): one
    launch per frame, or per batch of frames or bands, on the current
    stream, then one check that it finished. Inputs: uint8 planes, int32
    maps, bool masks, all contiguous and 16-byte aligned on one CUDA
    device; outputs as commit_ref's."""
    out, recon, prog = commit_launch(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
        is_intra=is_intra, inter_planes=inter_planes, i4_mask=i4_mask,
        i4_modes=i4_modes, grid=grid)
    check_progress(prog, mbw)
    return out, recon


def commit_cuda_diag(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw,
                     mbh, is_intra=None, inter_planes=None, i4_mask=None,
                     i4_modes=None):
    """The first port's kernel (commit_diag_kernel), one launch per
    anti-diagonal. Off the main path: kept so that a run on the card can
    time it beside commit_cuda. One frame only."""
    (y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb), kw = _as_batch(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, is_intra,
        inter_planes, i4_mask, i4_modes)
    args, out, recon, _tab = _kernel_args(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh, **kw)
    lib = _library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    for d in range(n_diags(mbw, mbh)):
        rc = lib.x264t_commit_diag(ctypes.byref(args), d, stream)
        if rc != 0:
            raise RuntimeError(f"commit kernel launch failed on diagonal {d}:"
                               f" CUDA error {rc}")
    return _first_item(out, recon)


@trace.spanned("analysis:commit")
def commit(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
           is_intra=None, inter_planes=None, i4_mask=None, i4_modes=None):
    """Wavefront commit with the outputs of x264_tpu's commit_dispatch, of
    one frame or of a batch (leading item axis). CUDA tensors go to the
    frame kernel (one launch either way), CPU tensors to commit_ref.
    `commit.launches` counts the frame kernel's launches."""
    fn = commit_cuda if y.is_cuda else commit_ref
    return fn(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
              is_intra=is_intra, inter_planes=inter_planes,
              i4_mask=i4_mask, i4_modes=i4_modes)


commit.launches = 0



def stack_calls(calls):
    """Per-item calls [(args, kwargs), ...] of one shape and variant, as
    `commit` takes them (args = (y, u, v, i16_mode, chroma_mode, qp_mb,
    qpc_mb, mbw, mbh)) -> the (args, kwargs) of their batch: every input
    stacked along a new leading item axis."""
    args0, kw0 = calls[0]
    mbw, mbh = args0[7], args0[8]
    if any(tuple(a[7:9]) != (mbw, mbh) or kw.keys() != kw0.keys()
           for a, kw in calls):
        raise ValueError("stack_calls: items differ in shape or variant")
    stacked = [torch.stack([a[i] for a, _ in calls]) for i in range(7)]
    kw = {}
    for key in kw0:
        if kw0[key] is None:
            kw[key] = None
        elif key == "inter_planes":
            kw[key] = tuple(torch.stack([k[key][c] for _, k in calls])
                            for c in range(3))
        else:
            kw[key] = torch.stack([k[key] for _, k in calls])
    return (*stacked, mbw, mbh), kw


def commit_batch(calls):
    """One commit for a list of per-item calls of one shape and variant
    (see stack_calls): one `commit` of their batch (one kernel launch on a
    card), and the per-item [(coeffs, recon), ...] back."""
    args, kw = stack_calls(calls)
    out, recon = commit(*args, **kw)
    return [({k: t[b] for k, t in out.items()}, tuple(r[b] for r in recon))
            for b in range(len(calls))]
