"""Lookahead: frame window + lowres slicetype analysis
(x264_tpu/encoder/lookahead.py).

The lowres intake (`lowres_plane`, `intra_blocks`), the cost search
(`_search_pair`, which scene-cut detection runs on every frame), the
bidirectional cost of a B candidate (`_bidir_cost`, which the adaptive
B-run decision compares path costs with), MB-tree (`_mbtree_propagate`,
`_mbtree_finish`, `Lookahead._mbtree_offsets`) and the `Lookahead` window
logic, which is host code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..ops._cuda import to_host
from ..ops.mc import _clamped
from ..utils import trace
from .encoder import (TYPE_AUTO, TYPE_B, TYPE_BREF, TYPE_I, TYPE_IDR,
                      TYPE_KEYFRAME, TYPE_P)


def lowres_plane(y):
    """Filtered half-res planes (reference frame_init_lowres_core):
    FILTER(a,b,c,d) = ((avg(a,b) + avg(c,d) + 1) >> 1) over vertical pairs,
    giving the 4 phase planes (f, half-H, half-V, half-HV).
    Returns (dst0, [dsth, dstv, dstc] stacked)."""
    H, W = y.shape
    t = _clamped(y, 0, 2, 0, 2).to(torch.int32)
    v0 = (t[0:H:2, :] + t[1:H + 1:2, :] + 1) >> 1
    v1 = (t[1:H + 1:2, :] + t[2:H + 2:2, :] + 1) >> 1

    def hfilt(a, o):
        return ((a[:, o:W + o:2] + a[:, o + 1:W + o + 1:2] + 1) >> 1) \
            .to(torch.uint8)

    return hfilt(v0, 0), torch.stack([hfilt(v0, 1), hfilt(v1, 0),
                                      hfilt(v1, 1)])


@trace.spanned("lookahead:search")
def _search_pair(low_cur, low_ref, ref_phases=None, *, srange: int = 8):
    """Dense +-srange full-pel search of cur against ref on lowres, offsets
    in raster order, a later offset winning only on a strictly lower SAD;
    with ref_phases, the 3 half-pel phase planes sampled at the winner
    lower the cost (the MV stays full-pel).
    Returns (sad_blk [bh, bw], mv [bh, bw, 2]) per 8x8 block."""
    H, W = low_cur.shape
    bh, bw = H // 8, W // 8
    dev = low_cur.device
    cur = low_cur.to(torch.int32)
    ref_pad = _clamped(low_ref, srange, srange, srange, srange) \
        .to(torch.int32)
    best = torch.full((bh, bw), 1 << 30, dtype=torch.int32, device=dev)
    mv = torch.zeros((bh, bw, 2), dtype=torch.int32, device=dev)
    offs = [(dx, dy) for dy in range(-srange, srange + 1)
            for dx in range(-srange, srange + 1)]
    off_t = const(np.asarray(offs, np.int32), dev)
    for k, (dx, dy) in enumerate(offs):
        shifted = ref_pad[srange + dy:srange + dy + H,
                          srange + dx:srange + dx + W]
        sad = (shifted - cur).abs().reshape(bh, 8, bw, 8).sum(
            (1, 3), dtype=torch.int32)
        better = sad < best
        best = torch.where(better, sad, best)
        mv = torch.where(better[..., None], off_t[k], mv)
    if ref_phases is not None:
        pad = srange + 1
        cur_t = cur.reshape(bh, 8, bw, 8).transpose(1, 2)
        rows = (torch.arange(bh, device=dev)[:, None, None, None] * 8 + pad
                + torch.arange(8, device=dev)[None, None, :, None]
                + mv[:, :, 1][:, :, None, None]).long()
        cols = (torch.arange(bw, device=dev)[None, :, None, None] * 8 + pad
                + torch.arange(8, device=dev)[None, None, None, :]
                + mv[:, :, 0][:, :, None, None]).long()
        for k in range(3):
            ph = _clamped(ref_phases[k], pad, pad, pad, pad) \
                .to(torch.int32)[rows, cols]
            psad = (ph - cur_t).abs().sum((2, 3), dtype=torch.int32)
            best = torch.minimum(best, psad)
    return best, mv


def intra_blocks(low_cur):
    """Per-8x8-block intra cost on the lowres plane: SAD against the DC
    prediction plus the per-block lowres intra penalty."""
    H, W = low_cur.shape
    bh, bw = H // 8, W // 8
    tiles = low_cur.to(torch.int32).reshape(bh, 8, bw, 8).transpose(1, 2)
    dc = (tiles.sum(dim=(2, 3), dtype=torch.int32) + 32) >> 6
    return (tiles - dc[:, :, None, None]).abs().sum(
        dim=(2, 3), dtype=torch.int32) + 5 * 8


@trace.spanned("lookahead:bidir")
def _bidir_cost(low_b, low_p0, low_p1, mv0, mv1):
    """Cost per 8x8 block of the average of the two references, each at
    the MV its own search found (mv0 / mv1 [bh, bw, 2], within +-8)."""
    H, W = low_b.shape
    bh, bw = H // 8, W // 8
    dev = low_b.device
    PAD = 16
    ar8 = torch.arange(8, device=dev)

    def warp(ref, mv):
        pad = _clamped(ref, PAD, PAD, PAD, PAD).to(torch.int32)
        rows = (torch.arange(bh, device=dev)[:, None, None, None] * 8 + PAD
                + ar8[None, None, :, None] + mv[:, :, 1][:, :, None, None])
        cols = (torch.arange(bw, device=dev)[None, :, None, None] * 8 + PAD
                + ar8[None, None, None, :] + mv[:, :, 0][:, :, None, None])
        return pad[rows.long(), cols.long()]

    avg = (warp(low_p0, mv0) + warp(low_p1, mv1) + 1) >> 1
    tiles = low_b.to(torch.int32).reshape(bh, 8, bw, 8).transpose(1, 2)
    return (avg - tiles).abs().sum((2, 3), dtype=torch.int32)


class Lookahead:
    """Sliding lookahead window + slicetype decision.

    Entries are dicts {idx, planes, pic, lowres (device), icost_blk}.
    Costs are memoized by absolute frame indices (p0, p1, b). `prev` keeps
    the last dispatched non-B frame's lowres alive."""

    def __init__(self, p) -> None:
        self.p = p
        self.window: list[dict] = []
        self.prev: dict | None = None
        self._costs: dict = {}
        self.threshold = p.scenecut_threshold / 100.0
        # a full B run and the frame past it; MB-tree deepens the window
        # toward rc.lookahead so the propagation has real depth
        self.depth = max(p.bframe + 2, 2)
        self.mbtree = bool(getattr(p.rc, "mb_tree", False))
        if self.mbtree:
            self.depth = max(self.depth, min(max(p.rc.lookahead, 8), 24))
            self.tree_strength = 5.0 * (1.0 - p.rc.qcompress)
        if p.rc.vbv_buffer_size and p.rc.vbv_max_bitrate:
            self.depth = max(self.depth, min(max(p.rc.lookahead, 8), 40))

    # ------------------------------------------------------------- intake
    @trace.spanned("lookahead:push")
    def push(self, planes, pic, idx) -> None:
        """planes: [y, u, v] tensors on the encoder's device."""
        low, phases = lowres_plane(planes[0])
        self.window.append({
            "idx": idx, "planes": planes, "pic": pic, "lowres": low,
            "lowres_ph": phases, "icost_blk": intra_blocks(low),
        })

    def __len__(self) -> int:
        return len(self.window)

    def reset(self) -> None:
        self.window = []
        self.prev = None
        self._costs = {}

    # -------------------------------------------------------------- costs
    def _entry(self, idx):
        if self.prev is not None and self.prev["idx"] == idx:
            return self.prev
        for e in self.window:
            if e["idx"] == idx:
                return e
        raise KeyError(f"lookahead: frame {idx} not in window")

    def _fields(self, p0, p1, b):
        """Memoized per-block cost fields for coding frame b with anchors
        p0 (fwd) / p1 (bwd); b == p1 means P, p0 == b intra."""
        key = (p0, p1, b)
        if key in self._costs:
            return self._costs[key]
        eb = self._entry(b)
        ic = eb["icost_blk"]
        if p0 == b:
            out = {"cost": int(to_host(ic.sum(), "lookahead_cost")),
                   "cost_blk": ic, "mv": None,
                   "intra_blk": ic}
        else:
            e0 = self._entry(p0)
            sad0, mv0 = _search_pair(eb["lowres"], e0["lowres"],
                                     e0.get("lowres_ph"))
            best = sad0
            if b != p1:
                e1 = self._entry(p1)
                sad1, mv1 = _search_pair(eb["lowres"], e1["lowres"],
                                         e1.get("lowres_ph"))
                bi = _bidir_cost(eb["lowres"], e0["lowres"], e1["lowres"],
                                 mv0, mv1)
                best = torch.minimum(best, torch.minimum(sad1, bi))
            blk = torch.minimum(best, ic)
            out = {"cost": int(to_host(blk.sum(), "lookahead_cost")),
                   "cost_blk": blk, "mv": mv0,
                   "intra_blk": ic}
        self._costs[key] = out
        return out

    def frame_cost(self, p0, p1, b) -> int:
        return self._fields(p0, p1, b)["cost"]

    def planned_costs(self) -> list:
        """Planned lowres cost of every queued frame, display order (feeds
        the VBV lookahead walk)."""
        out = []
        prev_idx = self.prev["idx"] if self.prev is not None else None
        for e in self.window:
            if prev_idx is None:
                out.append(float(to_host(e["icost_blk"].sum(),
                                         "lookahead_cost")))
            else:
                out.append(float(self.frame_cost(prev_idx, e["idx"],
                                                 e["idx"])))
            prev_idx = e["idx"]
        return out

    def _path_cost(self, start_idx, path: str) -> int:
        """Cost of a typed path: path[i] types frame start_idx + 1 + i."""
        total = 0
        pos = [start_idx + 1 + i for i in range(len(path))]
        nxt = None
        next_nonb = [None] * len(path)
        for i in reversed(range(len(path))):
            if path[i] != 'B':
                nxt = pos[i]
            next_nonb[i] = nxt
        last_nonb = start_idx
        for i, t in enumerate(path):
            if t != 'B':
                total += self.frame_cost(last_nonb, pos[i], pos[i])
                last_nonb = pos[i]
            elif next_nonb[i] is not None:
                total += self.frame_cost(last_nonb, next_nonb[i], pos[i])
        return total

    # ----------------------------------------------------------- scenecut
    def _scenecut_internal(self, p0, p1, last_keyframe) -> bool:
        icost = max(self.frame_cost(p1, p1, p1), 1)
        pcost = self.frame_cost(p0, p1, p1)
        gop_size = self._entry(p1)["idx"] - last_keyframe
        tmax = self.threshold
        tmin = tmax * 0.25
        kmin = max(self.p.keyint_min, 1)
        kmax = max(self.p.keyint_max, kmin + 1)
        if self.p.keyint_min == self.p.keyint_max:
            tmin = tmax
        if gop_size <= kmin / 4 or self.p.intra_refresh:
            bias = tmin / 4
        elif gop_size <= kmin:
            bias = tmin * gop_size / kmin
        else:
            bias = tmin + (tmax - tmin) * (gop_size - kmin) \
                / max(kmax - kmin, 1)
        return pcost >= (1.0 - bias) * icost

    def _scenecut(self, p0, p1, last_keyframe) -> bool:
        """Flash-aware scenecut: a run of cut frames shorter than the
        analysis span is a flash, not a cut."""
        if self.threshold <= 0:
            return False
        if not self._scenecut_internal(p0, p1, last_keyframe):
            return False
        span = (self.p.bframe + 1) if self.p.bframe else 1
        avail = {e["idx"] for e in self.window}
        for curp1 in range(p1 + 1, p1 + span + 1):
            if curp1 not in avail:
                break
            if not self._scenecut_internal(p0, curp1, last_keyframe):
                return False
        return True

    # ------------------------------------------------------------- decide
    def _consume(self, count, new_prev, idr_idx=None):
        prev_idx = self.prev["idx"] if self.prev is not None else None
        for e in self.window[:count]:
            key = (prev_idx, e["idx"], e["idx"])
            if prev_idx is None or e["idx"] == idr_idx:
                e["plan_cost"] = float(to_host(e["icost_blk"].sum(),
                                               "lookahead_cost"))
            elif key in self._costs:
                e["plan_cost"] = float(self._costs[key]["cost"])
            else:
                e["plan_cost"] = float(self.frame_cost(*key))
            prev_idx = e["idx"]
        keep = {k: new_prev[k] for k in ("idx", "lowres", "lowres_ph",
                                         "icost_blk")}
        keep["pic"] = None
        self.prev = keep
        self.window = self.window[count:]
        live = {e["idx"] for e in self.window} | {keep["idx"]}
        self._costs = {k: v for k, v in self._costs.items()
                       if all(i in live for i in k)}

    @trace.spanned("lookahead:decide")
    def decide(self, last_keyframe: int, flush: bool):
        """Decide the next minigop once enough frames are buffered.
        Returns a list of (entry, ftype, ref_fwd_idx, ref_bwd_idx) in
        coding order, or None if more input is needed."""
        if not self.window:
            return None

        def forced(e):
            p = e["pic"]
            return p.i_type if p is not None else TYPE_AUTO

        w = self.window
        first = w[0]
        fidx = first["idx"]
        head_forced = forced(first) in (TYPE_IDR, TYPE_KEYFRAME, TYPE_I,
                                        TYPE_P)
        if not flush and not head_forced and len(self.window) < self.depth:
            return None

        keyint = max(self.p.keyint_max, 1)
        kmin = (self.p.keyint_min if self.p.keyint_min > 0
                else max(1, keyint // 10))
        due_idx = last_keyframe + keyint

        f0 = forced(first)
        if (f0 in (TYPE_IDR, TYPE_KEYFRAME, TYPE_I)
                or fidx >= due_idx or self.prev is None
                or (f0 == TYPE_AUTO
                    and fidx - last_keyframe >= kmin
                    and self._scenecut(self.prev["idx"], fidx,
                                       last_keyframe))):
            if self.mbtree:
                first["tree_off"] = self._mbtree_offsets(0)
            self._consume(1, first, idr_idx=first["idx"])
            return [(first, TYPE_IDR, None, None)]

        nb = 0
        nb_max = self.p.bframe
        if nb_max > 0:
            limit = min(nb_max, len(w) - 1)
            limit = min(limit, max(0, due_idx - fidx - 1))
            run = 0
            for j in range(limit):
                if forced(w[j]) in (TYPE_AUTO, TYPE_B, TYPE_BREF):
                    run += 1
                else:
                    break
            limit = run
            if getattr(self.p, "bframe_adaptive", 0) == 0:
                nb = limit
            else:
                while nb < limit:
                    if len(w) <= nb + 2:
                        if not flush:
                            return None
                        break
                    prev_idx = self.prev["idx"]
                    cost_p = self._path_cost(prev_idx, "B" * nb + "PP")
                    cost_b = self._path_cost(prev_idx, "B" * nb + "BP")
                    if cost_b < cost_p:
                        nb += 1
                    else:
                        break
            nb = min(nb, max(0, len(w) - 1))
            if self.threshold > 0:
                p0 = self.prev["idx"]
                for j in range(nb):
                    if self._scenecut(p0, w[j]["idx"], last_keyframe):
                        nb = j
                        break
                    p0 = w[j]["idx"]

        anchor = w[nb]
        if forced(anchor) in (TYPE_IDR, TYPE_KEYFRAME, TYPE_I):
            out = [(w[j], TYPE_P, None, None) for j in range(nb)]
            out.append((anchor, TYPE_IDR, None, None))
            self._consume(nb + 1, anchor, idr_idx=anchor["idx"])
            return out
        if self.mbtree:
            anchor["tree_off"] = self._mbtree_offsets(nb)
        out = [(anchor, TYPE_P, None, None)]
        prev_idx = self.prev["idx"]
        for j in range(nb):
            out.append((w[j], TYPE_B, prev_idx, anchor["idx"]))
        self._consume(nb + 1, anchor)
        return out

    def _mbtree_offsets(self, anchor_pos):
        """Backward MB-tree propagation over the rest of the window into
        the anchor about to be coded (the undecided tail taken as a chain
        of P frames). Returns the anchor's per-block QP offsets [bh, bw]
        float32 on the host, zero-mean (MB-tree moves quality within the
        frame; the frame's QP stays rate control's), or None when no frame
        follows the anchor."""
        w = self.window
        if anchor_pos + 1 >= len(w):
            return None
        anchor = w[anchor_pos]
        prop = torch.zeros_like(anchor["icost_blk"], dtype=torch.float32)
        for k in range(len(w) - 1, anchor_pos, -1):
            f = self._fields(w[k - 1]["idx"], w[k]["idx"], w[k]["idx"])
            prop = _mbtree_propagate(f["intra_blk"], f["cost_blk"], prop,
                                     f["mv"])
        off = to_host(_mbtree_finish(anchor["icost_blk"], prop,
                                     self.tree_strength),
                      "mbtree_offsets").numpy()
        return off - off.mean()


# ----------------------------------------------------------------- MB-tree
def _ordered_scatter_add(size: int, idx, val):
    """out[idx[k]] += val[k] in float32, the additions onto one target made
    in the order of k: what a sequential scatter-add gives, and the same
    on the CPU and on a card (an atomic scatter-add fixes no order, and
    float32 addition is not associative). A stable sort groups the sources
    by target; round r then adds every target's r-th source at once."""
    dev = val.device
    sidx, perm = torch.sort(idx, stable=True)
    sval = val[perm]
    pos = torch.arange(sidx.shape[0], device=dev)
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = sidx[1:] != sidx[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    out = torch.zeros(size, dtype=torch.float32, device=dev)
    for r in range(int(to_host(rank.max(), "mbtree_scatter")) + 1):
        m = rank == r
        with trace.waits("mbtree_scatter"):       # a boolean-mask read
            t = sidx[m]
        with trace.waits("mbtree_scatter"):
            v = sval[m]
        out[t] = out[t] + v
    return out


@trace.spanned("lookahead:mbtree_propagate")
def _mbtree_propagate(intra_blk, cost_blk, prop_in, mv):
    """One backward propagation step (macroblock_tree_propagate, the
    single-reference P form): the share of each block's information that
    it inherits from its reference goes onto the reference's blocks
    through the lowres MV, split bilinearly over the (up to) four blocks
    it overlaps, targets clipped to the frame. Returns the reference
    frame's propagate-in [bh, bw] float32.

    x264_tpu makes four scatter-adds one after the other, which XLA on the
    CPU runs source by source in raster order; `_ordered_scatter_add` over
    the four source lists end to end adds in the same order."""
    bh, bw = intra_blk.shape
    dev = intra_blk.device
    f32 = torch.float32
    intra = intra_blk.to(f32).clamp(min=1.0)
    inter = torch.minimum(cost_blk, intra_blk).to(f32)
    fraction = (1.0 - inter / intra).clamp(0.0, 1.0)
    amount = (intra + prop_in) * fraction
    x0 = torch.arange(bw, device=dev)[None, :] * 8 + mv[:, :, 0]
    y0 = torch.arange(bh, device=dev)[:, None] * 8 + mv[:, :, 1]
    bx, by = x0 >> 3, y0 >> 3                       # floor
    fx, fy = (x0 - bx * 8).to(f32), (y0 - by * 8).to(f32)
    idx, val = [], []
    for dbx, dby, wgt in ((0, 0, (8 - fx) * (8 - fy)), (1, 0, fx * (8 - fy)),
                          (0, 1, (8 - fx) * fy), (1, 1, fx * fy)):
        tx = (bx + dbx).clamp(0, bw - 1)
        ty = (by + dby).clamp(0, bh - 1)
        idx.append((ty * bw + tx).reshape(-1))
        val.append((amount * (wgt / 64.0)).reshape(-1))
    return _ordered_scatter_add(bh * bw, torch.cat(idx).long(),
                                torch.cat(val)).reshape(bh, bw)


@trace.spanned("lookahead:mbtree_finish")
def _mbtree_finish(intra_blk, prop, strength):
    """Per-block QP offsets (macroblock_tree_finish):
    -strength * log2((intra + propagate) / intra) as a difference of logs.

    log2 is taken in float64 and rounded to float32, as ops/aq.py takes
    it: correctly rounded on the CPU and on a card alike, where the
    float32 log2 of either may be an ulp off. The sum, the difference and
    the product stay in float32, as in x264_tpu."""
    intra = intra_blk.to(torch.float32).clamp(min=1.0)

    def log2(x):
        return torch.log2(x.to(torch.float64)).to(torch.float32)

    return (log2(intra + prop) - log2(intra)) * float(np.float32(-strength))
