"""Encoder core: lifecycle + per-frame orchestration
(x264_tpu/encoder/encoder.py), on an explicit torch device.

Public API as in x264_tpu: Encoder(params, device=...), .headers(),
.encode(pic) -> (nals, PicOut), .delayed_frames(), .reconfig(),
.intra_refresh(), .invalidate_reference(), .close(), and .log. The frame
types, `Picture`, `PicOut`, `EncoderError` and `validate_parameters` are
copied from x264_tpu's module unchanged; parameters, SPS/PPS/SEI writers,
rate control and the logger are the port's own copies of x264_tpu's host
modules. I / IDR, P and non-reference B frames are encoded at every
preset, CAVLC and CABAC, with the adaptive B-run decision, MB-tree, noise
reduction, periodic intra refresh (the column sweep and its recovery
points), PCM frames and SSIM. What x264_tpu refuses the port refuses too:
interlaced, and P frames under force_pcm.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import params as P
from ..device import resolve_device
from ..entropy import nal as nal_mod
from ..entropy import sets
from ..entropy.nal import annexb_bytes
from ..entropy.slice_hdr import (SLICE_TYPE_B, SLICE_TYPE_I, SLICE_TYPE_P,
                                 SliceHeader)
from ..ops import mc as mc_ops
from ..ops._cuda import to_device, to_host
from ..utils import trace

# frame_encode, intra, lookahead and ratecontrol import the frame types
# below from this module, so this module imports them inside the functions
# that use them, as x264_tpu/encoder/encoder.py does.

__all__ = ["Encoder", "Picture", "PicOut", "EncoderError", "annexb_bytes"]

# ---- copied from x264_tpu/encoder/encoder.py (frame types, picture
# dataclasses, validate_parameters), unchanged


# frame types (reference x264.h:255-263)
TYPE_AUTO, TYPE_IDR, TYPE_I, TYPE_P, TYPE_BREF, TYPE_B, TYPE_KEYFRAME = \
    0, 1, 2, 3, 4, 5, 6


@dataclass
class Picture:
    """Input picture (reference x264_picture_t, x264.h:864-906)."""
    planes: list                   # [Y, U, V] numpy arrays (input size)
    pts: int = 0
    i_type: int = TYPE_AUTO
    qp_offset: float = 0.0
    forced_qp: int = -1
    param: Optional[P.Params] = None
    opaque: object = None          # handed back via param.nalu_process


@dataclass
class PicOut:
    pts: int = 0
    dts: int = 0
    i_type: int = TYPE_IDR
    b_keyframe: bool = False
    qp: int = 0
    recon: Optional[list] = None   # reconstructed planes (display size)
    psnr: Optional[tuple] = None
    ssim: Optional[float] = None


class EncoderError(Exception):
    pass


class Planes(list):
    """A frame's [y, u, v] tensors on the encoder's device, padded to whole
    MBs, with the padded source luma kept on the host as numpy
    (`host_luma`): the weightp fit reads it without a copy back from the
    device."""
    host_luma = None


def validate_parameters(p: P.Params) -> P.Params:
    """Clamp/reconcile params (reference validate_parameters encoder.c:423).

    Round-1 subset: grows as features land."""
    p = p.copy()
    if p.width <= 0 or p.height <= 0:
        raise EncoderError(f"invalid size {p.width}x{p.height}")
    if p.width % 2 or (p.height % 2 and p.csp == P.CSP_I420):
        raise EncoderError("width/height must be even for 4:2:0")
    if p.bitdepth not in (8, 10):
        raise EncoderError("bitdepth must be 8 or 10")
    qp_max_spec = P.QP_MAX_SPEC + p.qp_bd_offset
    p.rc.qp_min = max(0, min(p.rc.qp_min, qp_max_spec))
    p.rc.qp_max = max(0, min(p.rc.qp_max, qp_max_spec))
    if p.rc.rc_method == P.RC_CQP:
        if p.rc.qp_constant < 0:
            p.rc.qp_constant = 23 + p.qp_bd_offset
        qp = p.rc.qp_constant
        # per-slice-type CQP (reference validate_parameters: qp_min/max
        # span the I/P/B constants; I frames run ~qp-3 via ip_factor —
        # clamping all types to qp cost 1.8 dB on every I frame)
        import math as _math
        qp_i = int(round(qp - 6.0 * _math.log2(max(p.rc.ip_factor, 0.01))))
        qp_b = int(round(qp + 6.0 * _math.log2(max(p.rc.pb_factor, 0.01))))
        p.rc.qp_min = max(0, min(qp, qp_i, qp_b))
        p.rc.qp_max = min(qp_max_spec, max(qp, qp_i, qp_b))
        p.rc.aq_mode = P.AQ_NONE
        p.rc.mb_tree = False
    p.frame_reference = max(1, min(p.frame_reference, P.REF_MAX))
    # current multi-ref ceiling: 2 L0 references (per-MB selection +
    # te() ref_idx); presets asking for more are clamped so the SPS/PPS
    # signal what the MB layer can actually use
    p.frame_reference = min(p.frame_reference, 2)
    p.bframe = max(0, min(p.bframe, P.BFRAME_MAX))
    if p.keyint_max <= 0:
        p.keyint_max = 1
    if p.keyint_min < 0:
        p.keyint_min = min(p.keyint_max // 10, 25) if p.keyint_max > 1 else 1
    p.keyint_min = max(1, min(p.keyint_min, p.keyint_max // 2 + 1))
    if p.keyint_max == 1:
        p.scenecut_threshold = 0
        p.intra_refresh = False
    if p.intra_refresh:
        # PIR constraints (reference encoder.c:1087-1098): single ref;
        # B frames additionally unsupported here until the sweep handles
        # bi-directional reference geometry
        p.frame_reference = 1
        p.bframe = 0
    p.rc.lookahead = max(0, min(p.rc.lookahead, P.LOOKAHEAD_MAX))
    p.rc.lookahead = min(p.rc.lookahead, p.keyint_max)
    # MB-tree drives per-MB offsets from the lookahead; until the ABR/VBV
    # bit predictors are taught the offset-induced complexity shift
    # (reference rate_estimate_qscale folds it in), keep it to CRF where
    # the rate target is implicit
    if p.rc.rc_method != P.RC_CRF:
        p.rc.mb_tree = False
    if p.bframe == 0:
        p.bframe_pyramid = P.B_PYRAMID_NONE
        p.bframe_adaptive = P.B_ADAPT_NONE
    # round-1 feature gates
    if p.analyse.weighted_pred > 1:
        p.analyse.weighted_pred = 1   # SMART's dup-ref trick not needed:
        # weights apply directly on the single signaled ref
    # 8x8 transform unimplemented: must stay off until the mb-layer writes
    # transform_size_8x8_flag for inter MBs (spec 7.3.5)
    p.analyse.transform_8x8 = False
    if p.interlaced:
        raise EncoderError("interlaced encoding not yet implemented")
    if p.bitdepth != 8:
        raise EncoderError("10-bit not yet wired end-to-end")
    return p


def frame_redispatch(enc, job):
    """Re-run a pipelined frame's dispatch against its original references,
    by DPB tag (after an overflow re-encode repaired the DPB). frame_num /
    poc are restored around the call since dispatch advances them."""
    saved = (enc.frame_num, enc.poc)
    enc.frame_num, enc.poc = job["pre_state"]
    from . import frame_encode
    try:
        return frame_encode.dispatch_frame(enc, job["planes"], job["ftype"],
                                           job["qp"], ref_tag=job["ref_tag"],
                                           tree_off=job.get("tree_off"),
                                           pir=job.get("pir"),
                                           ref_bwd=job.get("ref_bwd"))
    finally:
        enc.frame_num, enc.poc = saved


class Encoder:
    """Top-level encoder. `device` names where the frames are encoded;
    "cuda" raises when CUDA is absent."""

    def __init__(self, params: P.Params, device="cuda") -> None:
        self.device = resolve_device(device)
        self.p = validate_parameters(params)
        from ..utils.log import Logger
        self.log = Logger(self.p.log_level)
        self.sps = sets.sps_init(self.p, self.p.sps_id)
        self.pps = sets.pps_init(self.p, self.sps, self.p.sps_id)
        self.mb_w, self.mb_h = self.p.mb_width, self.p.mb_height
        self.frame_num = 0
        self.idr_pic_id = 0
        self.frames_in = 0
        self.frames_out = 0
        self.last_keyframe = -(1 << 30)
        # decision-time keyframe tracker (keyint cadence advances when an
        # IDR is decided, not when it is dispatched)
        self._kf_decided = -(1 << 30)
        self.poc = 0
        from .lookahead import Lookahead
        from .ratecontrol import RateControl
        self.rc = RateControl(self.p)
        self._lookahead = Lookahead(self.p)
        self._dpb: list = []
        self.n_refs = min(self.p.frame_reference, 2)
        self._max_refs = max(self.n_refs, 2 if self.p.bframe > 0 else 1)
        self._pipe: list = []       # in-flight frame jobs
        self._pipe_depth = 1 if self.p.threads != 1 else 0
        self._ready: list = []      # decided, not yet dispatched
        # the periodic intra refresh sweep: pos == mb_w is "no sweep
        # active", prev_end the newest reference's refreshed end column
        self._pir_state = {"pos": float(self.mb_w), "since": 0,
                           "prev_end": 0}
        self._queued_refresh = False
        self._idr_display_base = 0
        self._coding_out = 0
        self._closed = False
        self._pending_ref_fields = None
        self._last_ref_fn = None
        self._src_luma: dict = {}   # DPB tag -> source luma (host numpy)
        self.stats = {"frames": 0, "bytes": 0,
                      "count": {"I": 0, "P": 0, "B": 0},
                      "qp_sum": {"I": 0.0, "P": 0.0, "B": 0.0},
                      "bytes_by_type": {"I": 0, "P": 0, "B": 0},
                      "ssd": np.zeros(3, dtype=np.float64),
                      "psnr_frames": 0}

    # ------------------------------------------------------------- headers
    def headers(self) -> list[nal_mod.NAL]:
        """SPS + PPS (+ SEI suite) NALs."""
        def sei(payload):
            return nal_mod.nal_encode(nal_mod.NAL_SEI,
                                      nal_mod.NAL_PRIORITY_DISPOSABLE,
                                      payload)
        nals = [
            nal_mod.nal_encode(nal_mod.NAL_SPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.sps_write(self.sps)),
            nal_mod.nal_encode(nal_mod.NAL_PPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.pps_write(self.pps)),
            sei(sets.sei_version(self.p)),
        ]
        if self.p.frame_packing >= 0:
            nals.append(sei(sets.sei_frame_packing(self.p.frame_packing)))
        if self.p.mastering_display:
            v = [int(x) for x in re.findall(r"-?\d+",
                                            self.p.mastering_display)]
            if len(v) == 10:
                nals.append(sei(sets.sei_mastering_display(
                    [(v[0], v[1]), (v[2], v[3]), (v[4], v[5])],
                    (v[6], v[7]), v[8], v[9])))
        if self.p.content_light_level:
            try:
                cll, fall = (int(x) for x in
                             self.p.content_light_level.split(","))
                nals.append(sei(sets.sei_content_light_level(cll, fall)))
            except ValueError:
                pass
        if self.p.alternative_transfer != 2:
            nals.append(sei(sets.sei_alternative_transfer(
                self.p.alternative_transfer)))
        return nals

    def delayed_frames(self) -> int:
        return len(self._pipe) + len(self._ready) + len(self._lookahead)

    # ------------------------------------------------------------- encode
    def encode(self, pic: Optional[Picture]) -> tuple[list, Optional[PicOut]]:
        """Encode one picture (numpy planes); returns (nals, pic_out).
        Frames pass the lookahead window, then a pipe one frame deep
        (threads != 1); drain with encode(None). Traced as the span
        "encoder:encode" of the picture's input index (utils/trace.py)."""
        with trace.span("encoder:encode",
                        frame=None if pic is None else self.frames_in):
            return self._encode(pic)

    def _encode(self, pic: Optional[Picture]):
        if self._closed:
            raise EncoderError("encoder closed")
        flush = pic is None
        if pic is not None:
            planes = self._pad_to_mb(pic.planes)
            self._lookahead.push(planes, pic, self.frames_in)
            self.frames_in += 1
        while True:
            decided = self._lookahead.decide(self._kf_decided, flush)
            if not decided:
                break
            for entry, ftype, _rf, _rb in decided:
                if ftype == TYPE_IDR:
                    self._kf_decided = entry["idx"]
            self._ready += decided
        self._dispatch_ready()
        if flush:
            if self._pipe:
                out = self._finalize_job(self._pipe.pop(0))
                self._dispatch_ready()
                return out
            return [], None
        if len(self._pipe) <= self._pipe_depth:
            return [], None
        out = self._finalize_job(self._pipe.pop(0))
        self._dispatch_ready()
        return out

    def _dispatch_ready(self) -> None:
        """Move decided frames into the pipe while it has room (at most
        pipe_depth + 1 in flight)."""
        while self._ready and len(self._pipe) <= self._pipe_depth:
            entry, ftype, ref_fwd, ref_bwd = self._ready.pop(0)
            with trace.span("encoder:enqueue", frame=entry["idx"]):
                self._enqueue_frame(entry["planes"], ftype, entry["pic"],
                                    entry["idx"], ref_fwd=ref_fwd,
                                    ref_bwd=ref_bwd,
                                    tree_off=entry.get("tree_off"))

    def _pir_advance(self, ftype, idx):
        """Advance the periodic intra refresh sweep by one frame (x264_tpu
        Encoder._pir_advance): a keyframe becomes a P frame that restarts
        the column sweep. Returns (ftype, pir geometry (start_col, end_col,
        ref_end_col or None) for dispatch_pframe or None, whether the frame
        is a recovery point)."""
        st = self._pir_state
        mbw = self.mb_w
        force = False
        if ftype in (TYPE_IDR, TYPE_I):
            if not self._dpb:
                # nothing decodable to sweep over: a real IDR
                st.update(pos=float(mbw), since=0, prev_end=0)
                return ftype, None, False
            ftype = TYPE_P
            force = True
        keyint = max(self.p.keyint_max, 1)
        inc = max((mbw - 1) / keyint, 1.0)
        pos = st["pos"]
        since = st["since"] + 1
        recovery = False
        if force or since >= keyint or (self._queued_refresh
                                        and pos + 0.5 >= mbw):
            pos, since = 0.0, 0
            self._queued_refresh = False
            recovery = True
            self.last_keyframe = idx
        start_col = int(pos + 0.5)
        pos += inc
        end_col = int(pos + 0.5)
        if end_col >= mbw - 1:
            pos = float(mbw)
            end_col = mbw - 1
        ref_end = st["prev_end"]
        st.update(pos=pos, since=since, prev_end=end_col)
        return ftype, (start_col, end_col,
                       ref_end if ref_end > 0 else None), recovery

    def _enqueue_frame(self, planes, ftype, pic, idx, ref_fwd=None,
                       ref_bwd=None, tree_off=None) -> None:
        """Dispatch one frame in coding order and append its job. A B
        frame (between the DPB entries tagged ref_fwd and ref_bwd) is no
        reference: it advances neither frame_num nor the decoder's list0[0]
        and leaves nothing in the DPB. Under intra refresh a keyframe after
        the first is a P frame that restarts the sweep."""
        from . import frame_encode
        pir_geom = None
        recovery = False
        if self.p.intra_refresh:
            ftype, pir_geom, recovery = self._pir_advance(ftype, idx)
        is_idr = ftype == TYPE_IDR
        if is_idr:
            self.last_keyframe = idx
            self.frame_num = 0
            self._idr_display_base = idx
            self._dpb.clear()
            self._last_ref_fn = None    # the decoder's DPB resets at IDR
        self.poc = 2 * (idx - self._idr_display_base)
        qp = self._decide_qp(ftype, pic, idx)
        pre_state = (self.frame_num, self.poc)
        finalize, retry, recon_dev, ref_fwd = frame_encode.dispatch_frame(
            self, planes, ftype, qp, ref_tag=ref_fwd, tree_off=tree_off,
            pir=pir_geom, ref_bwd=ref_bwd)
        if ftype != TYPE_B:
            # this frame is now the decoder's most recent reference, the
            # default list0[0] of the next frame (apply_ref_list_mod)
            self._last_ref_fn = self.frame_num
            # reference pictures advance frame_num (spec 7.4.3)
            self.frame_num = (self.frame_num + 1) % (
                1 << self.sps.log2_max_frame_num)
        tag = idx
        if recon_dev is not None:
            # the next frame's weightp fit reads this frame's source luma
            self._src_luma[tag] = planes.host_luma
            self._dpb_push(recon_dev, tag)
            live = {r["tag"] for r in self._dpb}
            for k in [k for k in self._src_luma if k not in live]:
                del self._src_luma[k]
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        dts = self._coding_out - (1 if self.p.bframe > 0 else 0)
        self._coding_out += 1
        self._pipe.append({
            "finalize": finalize, "retry": retry, "pts": pic.pts,
            "dts": dts, "ftype": ftype, "is_idr": is_idr, "qp": qp,
            "planes": planes, "tag": tag, "pre_state": pre_state,
            "ref_tag": ref_fwd, "ref_bwd": ref_bwd, "tree_off": tree_off,
            "pir": pir_geom, "recovery": recovery, "opaque": pic.opaque})

    def _finalize_job(self, job) -> tuple[list, PicOut]:
        """The job's NALs (SEIs added) and PicOut, and the stats; traced as
        the span "encoder:finalize" of the job's frame."""
        with trace.span("encoder:finalize", frame=job["tag"]):
            return self._finalize(job)

    def _finalize(self, job) -> tuple[list, PicOut]:
        from .intra import PayloadOverflow, aud_nal
        pts, ftype, is_idr, qp, planes = (job["pts"], job["ftype"],
                                          job["is_idr"], job["qp"],
                                          job["planes"])
        try:
            nals, recon = job["finalize"]()
        except PayloadOverflow:
            nals, recon, qp = self._overflow_reencode(job)
        if job.get("recovery"):
            # a sweep restart: a recovery point the stream can be joined
            # at (time_to_recovery = min(mb_w - 1, keyint) - 1)
            ttr = min(self.mb_w - 1, self.p.keyint_max) - 1
            nals = [nal_mod.nal_encode(
                nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                sets.sei_recovery_point(max(ttr, 0)))] + nals
        if self.sps.nal_hrd_parameters:
            # HRD SEIs: buffering period at every IDR, picture timing on
            # every AU; delays in ticks of 2 fields per frame
            hrd = []
            if is_idr:
                init_delay, init_offset = self.rc.hrd_fullness(
                    self.sps.hrd_bitrate_unscaled,
                    self.sps.hrd_cpb_size_unscaled)
                hrd.append(nal_mod.nal_encode(
                    nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                    sets.sei_buffering_period(self.sps, init_delay,
                                              init_offset)))
                self._hrd_bp_idx = self.frames_out
            cpb_delay = 2 * (self.frames_out
                             - getattr(self, "_hrd_bp_idx", 0))
            dpb_delay = 2 * max(0, pts - job.get("dts", pts))
            hrd.append(nal_mod.nal_encode(
                nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                sets.sei_pic_timing(self.sps, cpb_delay, dpb_delay)))
            nals = hrd + nals
        if self.sps.nal_hrd_parameters and self.sps.hrd_cbr:
            fill_bits = self.rc.hrd_filler_bits()
            if fill_bits:
                k = max(0, fill_bits // 8 - 6)   # startcode + hdr + stop
                nals = nals + [nal_mod.nal_encode(
                    nal_mod.NAL_FILLER, nal_mod.NAL_PRIORITY_DISPOSABLE,
                    b"\xff" * k + b"\x80")]
        if self.p.aud:
            nals = [aud_nal(ftype)] + nals
        if self.p.nalu_process is not None:
            for nal in nals:
                self.p.nalu_process(self, nal, job.get("opaque"))
        out = PicOut(pts=pts, dts=job.get("dts", pts), i_type=ftype,
                     b_keyframe=is_idr or bool(job.get("recovery")), qp=qp,
                     recon=[r[:self.p.height, :self.p.width] if i == 0 else
                            r[:self._chroma_h(), :self._chroma_w()]
                            for i, r in enumerate(recon)] if recon else None)
        self.frames_out += 1
        tkey = {TYPE_IDR: "I", TYPE_I: "I", TYPE_P: "P",
                TYPE_B: "B", TYPE_BREF: "B"}[ftype]
        self.stats["frames"] += 1
        self.stats["count"][tkey] += 1
        self.stats["qp_sum"][tkey] += qp
        nbytes = sum(len(n.payload) + 4 for n in nals)
        self.stats["bytes"] += nbytes
        self.stats["bytes_by_type"][tkey] += nbytes
        if self.p.analyse.psnr and recon is not None:
            src = [np.asarray(to_host(a, "psnr"))
                   for a in self._crop(planes)]
            rec = [np.asarray(to_host(b, "psnr")
                              if isinstance(b, torch.Tensor) else b)
                   for b in out.recon]
            for i, (a, b) in enumerate(zip(src, rec)):
                d = a.astype(np.float64) - b.astype(np.float64)
                self.stats["ssd"][i] += float((d * d).sum())
            self.stats["psnr_frames"] += 1
            out.psnr = self._frame_psnr(src, rec)
        if self.p.analyse.ssim and recon is not None:
            from ..ops.pixel import ssim as ssim_op
            rec_y = out.recon[0]
            if not isinstance(rec_y, torch.Tensor):
                rec_y = to_device(np.ascontiguousarray(rec_y), self.device,
                                  "ssim")
            out.ssim = float(to_host(ssim_op(self._crop(planes)[0],
                                             rec_y.to(self.device)),
                                     "ssim"))
            self.stats["ssim_sum"] = self.stats.get("ssim_sum", 0.0) \
                + out.ssim
            self.stats["ssim_frames"] = self.stats.get("ssim_frames", 0) + 1
        return nals, out

    # ------------------------------------------------------------ helpers
    def _chroma_w(self) -> int:
        return self.p.width // (2 if self.p.chroma_format_idc in (1, 2)
                                else 1)

    def _chroma_h(self) -> int:
        return self.p.height // (2 if self.p.chroma_format_idc == 1 else 1)

    def _crop(self, planes):
        return [planes[0][:self.p.height, :self.p.width],
                planes[1][:self._chroma_h(), :self._chroma_w()],
                planes[2][:self._chroma_h(), :self._chroma_w()]]

    def _frame_psnr(self, src, rec):
        peak = (1 << self.p.bitdepth) - 1
        vals = []
        for a, b in zip(src, rec):
            d = a.astype(np.float64) - b.astype(np.float64)
            mse = (d * d).mean()
            vals.append(10 * np.log10(peak * peak / max(mse, 1e-12)))
        return tuple(vals)

    @trace.spanned("encoder:intake")
    def _pad_to_mb(self, planes: list) -> Planes:
        """Pad planes to MB-aligned sizes by edge replication and move them
        to the encoder's device; the padded luma stays on the host too."""
        out = Planes()
        for i, pl in enumerate(planes):
            if i == 0:
                th, tw = self.mb_h * 16, self.mb_w * 16
            else:
                cdiv_w = 2 if self.p.chroma_format_idc in (1, 2) else 1
                cdiv_h = 2 if self.p.chroma_format_idc == 1 else 1
                th, tw = self.mb_h * 16 // cdiv_h, self.mb_w * 16 // cdiv_w
            pl = np.asarray(pl, np.uint8)
            ph, pw = th - pl.shape[0], tw - pl.shape[1]
            if ph or pw:
                pl = np.pad(pl, ((0, ph), (0, pw)), mode="edge")
            if i == 0:
                out.host_luma = pl
            out.append(to_device(np.ascontiguousarray(pl), self.device,
                                 "intake"))
        return out

    @trace.spanned("encoder:ratecontrol")
    def _decide_qp(self, ftype: int, pic: Picture, idx: int = None) -> int:
        if self.rc.vbv:
            ahead = [e.get("plan_cost", 0.0) for e, *_ in self._ready]
            self.rc.set_lookahead_costs(
                ahead + self._lookahead.planned_costs())
        return self.rc.start(ftype, pic.forced_qp, frame_idx=idx)

    def _overflow_reencode(self, job):
        """Payload overflow: re-encode the frame at higher QP, repair its
        DPB entry and re-dispatch in-flight frames."""
        from .intra import PayloadOverflow
        qp_try = job["qp"]
        while True:
            qp_try = min(qp_try + 4, P.QP_MAX_SPEC)
            finalize2, recon_dev2 = job["retry"](qp_try)
            try:
                nals, recon = finalize2()
                break
            except PayloadOverflow:
                if qp_try >= P.QP_MAX_SPEC:
                    raise
        if recon_dev2 is not None:
            self._dpb_replace(job["tag"], recon_dev2)
        for j2 in self._pipe:
            fin, retry, recon_dev, _ = frame_redispatch(self, j2)
            j2["finalize"], j2["retry"] = fin, retry
            if recon_dev is not None:
                self._dpb_replace(j2["tag"], recon_dev)
        return nals, recon, qp_try

    def _dpb_replace(self, tag, recon) -> None:
        for i, ref in enumerate(self._dpb):
            if ref.get("tag") == tag:
                self._dpb_push_entry(recon, tag, ref["frame_num"],
                                     ref["poc"], i)
                return
        raise AssertionError(f"DPB repair: tag {tag} already evicted "
                             "(retention must cover pipe depth)")

    def _dpb_push_entry(self, recon, tag, frame_num, poc, at=None):
        """Border-extended luma, its half-pel planes and the extended
        chroma, once per reference."""
        y_pad = mc_ops.pad_plane(recon[0])
        ref = {
            "y_pad": y_pad,
            "hpel": mc_ops.hpel_planes(y_pad),
            "cuv_pad": torch.stack(
                [mc_ops.pad_plane(recon[1], mc_ops.CPAD),
                 mc_ops.pad_plane(recon[2], mc_ops.CPAD)]),
            "frame_num": frame_num,
            "poc": poc,
            "tag": tag,
        }
        ref.update(self._pending_ref_fields or {})
        self._pending_ref_fields = None
        if at is None:
            self._dpb.append(ref)
        else:
            self._dpb[at] = ref

    def _dpb_push(self, recon, tag=-1) -> None:
        """Insert a reconstructed frame into the device DPB; retention
        exceeds the signalled count by the pipe depth so an in-flight
        frame's reference can be repaired after an overflow re-encode."""
        self._dpb_push_entry(recon, tag, self.frame_num, self.poc)
        keep = self._max_refs + self._pipe_depth
        while len(self._dpb) > keep:
            self._dpb.pop(0)

    def _slice_header(self, ftype: int, qp: int, first_mb: int = 0,
                      last_mb: int = -1, n_ref_l0: int = 1) -> SliceHeader:
        sh = SliceHeader(sps=self.sps, pps=self.pps)
        sh.slice_type = (SLICE_TYPE_I if ftype in (TYPE_IDR, TYPE_I) else
                         SLICE_TYPE_P if ftype == TYPE_P else SLICE_TYPE_B)
        sh.first_mb = first_mb
        sh.last_mb = last_mb if last_mb >= 0 else self.mb_w * self.mb_h - 1
        sh.frame_num = self.frame_num
        sh.idr = ftype == TYPE_IDR
        sh.idr_pic_id = self.idr_pic_id
        sh.poc_lsb = self.poc % (1 << self.sps.log2_max_poc_lsb)
        sh.qp = qp
        sh.num_ref_idx_l0_active = n_ref_l0
        sh.num_ref_idx_l1_active = 1
        sh.num_ref_idx_override = (
            sh.slice_type in (SLICE_TYPE_P, SLICE_TYPE_B)
            and (self.pps.num_ref_idx_l0_active != sh.num_ref_idx_l0_active
                 or (sh.slice_type == SLICE_TYPE_B
                     and self.pps.num_ref_idx_l1_active
                     != sh.num_ref_idx_l1_active)))
        if not self.p.deblocking_filter:
            sh.disable_deblocking_filter_idc = 1
        sh.alpha_c0_offset = self.p.deblocking_filter_alphac0 * 2
        sh.beta_offset = self.p.deblocking_filter_beta * 2
        return sh

    def reconfig(self, new_params: P.Params) -> None:
        """Runtime re-config of the mutable subset (x264_tpu
        Encoder.reconfig)."""
        mutable = ["rc", "analyse", "deblocking_filter",
                   "deblocking_filter_alphac0", "deblocking_filter_beta",
                   "keyint_max", "scenecut_threshold"]
        for name in mutable:
            setattr(self.p, name, getattr(new_params, name))

    def intra_refresh(self) -> None:
        """Queue an intra refresh: under --intra-refresh the next P frame
        after the current sweep completes restarts the column sweep;
        without it, the next frame is coded IDR."""
        if self.p.intra_refresh:
            self._queued_refresh = True
        else:
            self.last_keyframe = -(1 << 30)
            self._kf_decided = -(1 << 30)

    def invalidate_reference(self, pts: int) -> int:
        """Mark reconstructed frames with pts >= `pts` unusable (the decoder
        lost them). Older entries stay usable; the next P frame references
        the newest survivor through ref_pic_list_modification
        (inter.apply_ref_list_mod). With none left, or a one-frame DPB, the
        next frame is forced IDR. Returns 0 when something was dropped or
        nothing is left, else -1 (x264_tpu Encoder.invalidate_reference)."""
        keep = [r for r in self._dpb if r["tag"] < pts]
        dropped = len(self._dpb) - len(keep)
        self._dpb = keep
        if dropped and self.sps.num_ref_frames < 2:
            # a survivor would be outside the decoder's one-frame sliding
            # window: the only conformant recovery is an IDR
            self._dpb = []
        if not self._dpb:
            self.last_keyframe = -(1 << 30)
            self._kf_decided = -(1 << 30)
        return 0 if dropped or not self._dpb else -1

    def close(self) -> dict:
        self._closed = True
        self.rc.write_stats()
        return self.stats
