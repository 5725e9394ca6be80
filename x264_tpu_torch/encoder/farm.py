"""Encode farm: S independent streams batched on one card
(x264_tpu/encoder/farm.py).

The reference scales throughput by running many encoder processes per
machine (doc/threads.txt's frame-threads are its per-stream axis). Here
the S streams advance in lockstep, one frame position at a time, and the
one stage that is a serial chain, the wavefront commit, runs for all S
streams in ONE batched launch of the commit kernel (ops/commit.py
`commit_batch`: the S frames are the items of the batch). The other
stages run per stream.

Scope as x264_tpu's farm: IPPP, CQP (per-slice-type I / P QPs), CAVLC, up
to 2 L0 references, identity weights (no weightp), the same analysis
flags as the single-stream Encoder at these settings, so that each
stream's bytes equal the port's `Encoder` with `weighted_pred 0`. The
host tail per stream is the slice header and the byte append.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..entropy import nal as nal_mod
from ..entropy import sets
from ..ops import mc
from ..ops._cuda import to_host
from ..ops.commit import commit_batch
from ..ops.tables import chroma_qp
from ..params import ANALYSE_I4x4, ANALYSE_PSUB16x16
from . import inter, intra
from .encoder import TYPE_IDR, TYPE_P, Encoder, validate_parameters


class FarmEncoder:
    """Lockstep S-stream IPPP encoder on one torch device (default cuda,
    which raises where there is none): one commit launch per frame
    position for all S streams."""

    def __init__(self, p, streams: int, device="cuda"):
        self.device = resolve_device(device)
        self.p = validate_parameters(p)
        self.S = streams
        self.sps = sets.sps_init(self.p, self.p.sps_id)
        self.pps = sets.pps_init(self.p, self.sps, self.p.sps_id)
        self.mb_w, self.mb_h = self.p.mb_width, self.p.mb_height
        self.qp = self.p.rc.qp_constant
        # per-slice-type CQP matching the single-stream rate control
        # (ratecontrol.py RC_CQP: I frames run qp - 6*log2(ip_factor))
        self.qp_i = int(min(max(
            round(self.qp - 6.0 * math.log2(self.p.rc.ip_factor)),
            self.p.rc.qp_min), self.p.rc.qp_max))
        self.frame_num = 0
        self.poc = 0
        self.idr_pic_id = 0
        self._dpb = []     # up to n_refs frame positions, S refs each
        self.recon = None  # the last frame position's reconstructions
        mbw, mbh = self.mb_w, self.mb_h
        cqpo = self.p.analyse.chroma_qp_offset

        def maps(qp):
            q = torch.full((mbh, mbw), qp, dtype=torch.int32)
            qc = torch.from_numpy(chroma_qp(q.numpy(), cqpo)).to(torch.int32)
            return q.to(self.device), qc.to(self.device)

        self.qp_mb, self.qpc_mb = maps(self.qp)
        self.qp_mb_i, self.qpc_mb_i = maps(self.qp_i)
        self.cap_words = (mbw * mbh * intra.cap_bytes_per_mb(
            min(self.qp, self.qp_i))) // 4
        self.me_range = min(self.p.analyse.me_range, mc.PAD - 8)
        self.lam = max(1, int(round(2.0 ** ((self.qp - 12) / 6.0))))
        # signalled L0 depth as the single-stream Encoder's (--ref N
        # clamped to 2); the first P after an IDR has one
        self.n_refs = min(self.p.frame_reference, 2)
        an = self.p.analyse
        partitions = bool(an.inter & ANALYSE_PSUB16x16)
        self._i4 = bool(an.intra & ANALYSE_I4x4)
        self._tail = dict(mbw=mbw, mbh=mbh, cap_words=self.cap_words,
                          deblock=self.p.deblocking_filter,
                          a_off=self.p.deblocking_filter_alphac0 * 2,
                          b_off=self.p.deblocking_filter_beta * 2, cqpo=cqpo)
        # the single-stream dispatch's flags (inter.dispatch_pframe),
        # weightp aside: identity weights
        self._p_flags = dict(
            mbw=mbw, mbh=mbh, me_range=self.me_range,
            decimate=an.dct_decimate, i4=self._i4,
            two_refs=self.p.frame_reference >= 2,
            p8x8=partitions and not self.p.cabac,
            me_seeded=an.me_method <= 2, partitions=partitions,
            rd=an.subpel_refine >= 7)

    def headers(self):
        return [
            nal_mod.nal_encode(nal_mod.NAL_SPS,
                               nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.sps_write(self.sps)),
            nal_mod.nal_encode(nal_mod.NAL_PPS,
                               nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.pps_write(self.pps)),
            nal_mod.nal_encode(nal_mod.NAL_SEI,
                               nal_mod.NAL_PRIORITY_DISPOSABLE,
                               sets.sei_version(self.p)),
        ]

    def _slice_header(self, ftype, n_ref_l0=1):
        return Encoder._slice_header(self, ftype,
                                     self.qp if ftype == TYPE_P
                                     else self.qp_i, n_ref_l0=n_ref_l0)

    def _i_frames(self, planes):
        """I frames of all streams: decide per stream, one commit, then
        CAVLC and the deblock per stream."""
        modes = [intra.decide_iframe(y, u, v, self.qp_mb_i, i4=self._i4)
                 for y, u, v in planes]
        committed = commit_batch([
            intra.iframe_commit_inputs(y, u, v, self.qp_mb_i, self.qpc_mb_i,
                                       m, mbw=self.mb_w, mbh=self.mb_h)
            for (y, u, v), m in zip(planes, modes)])
        return [intra.iframe_cavlc_tail(m, coeffs, recon, self.qp_mb_i,
                                        self.qp_i, **self._tail)[:3]
                for m, (coeffs, recon) in zip(modes, committed)]

    def _p_frames(self, planes, refs):
        """P frames of all streams against refs[s] (1 or 2 DPB entries
        each): analysis per stream, one commit, then the merge, CAVLC and
        the deblock per stream."""
        f = self._p_flags
        xms = [inter.p_analyse(y, u, v, r, self.qp_mb, self.qpc_mb, self.lam,
                               None, **f)
               for (y, u, v), r in zip(planes, refs)]
        committed = commit_batch([
            inter.mixed_commit_inputs(y, u, v, self.qp_mb, self.qpc_mb, xm,
                                      mbw=self.mb_w, mbh=self.mb_h,
                                      i4=self._i4)
            for (y, u, v), xm in zip(planes, xms)])
        out = []
        for xm, c, r in zip(xms, committed, refs):
            cm = inter.p_merge_levels(xm, c, mbw=self.mb_w, mbh=self.mb_h,
                                      two_refs=f["two_refs"], i4=self._i4)
            out.append(inter.p_finish(
                cm, self.qp, i4=self._i4, two_refs=f["two_refs"],
                ref1_valid=len(r) == 2, partitions=f["partitions"],
                **self._tail)[:3])
        return out

    def _dpb_entry(self, recon):
        y_pad = mc.pad_plane(recon[0])
        return {"y_pad": y_pad, "hpel": mc.hpel_planes(y_pad),
                "cuv_pad": torch.stack([mc.pad_plane(recon[1], mc.CPAD),
                                        mc.pad_plane(recon[2], mc.CPAD)])}

    def encode_batch(self, planes_s, idr: bool):
        """Encode one frame position for all S streams.

        planes_s: list of S [y, u, v] numpy frames (MB-aligned).
        Returns a list of S NAL lists. The commit is one batched launch;
        the host tail is S slice headers and byte appends. `self.recon`
        then holds each stream's reconstruction (device tensors)."""
        planes = [[torch.from_numpy(p).to(self.device) for p in f]
                  for f in planes_s]
        n_ref = 1
        if idr:
            self.frame_num = 0
            self.poc = 0
            frames = self._i_frames(planes)
            self._dpb = []
            ftype, ntype, ridc = (TYPE_IDR, nal_mod.NAL_SLICE_IDR,
                                  nal_mod.NAL_PRIORITY_HIGHEST)
        else:
            # the second L0 reference is the next most recent DPB entry
            # (the decoder's default list0[1]); none on the first P
            have2 = self.n_refs >= 2 and len(self._dpb) >= 2
            n_ref = 2 if have2 else 1
            refs = [[self._dpb[-1][s]] + ([self._dpb[-2][s]] if have2
                                          else [])
                    for s in range(self.S)]
            frames = self._p_frames(planes, refs)
            ftype, ntype, ridc = (TYPE_P, nal_mod.NAL_SLICE,
                                  nal_mod.NAL_PRIORITY_HIGH)
        self.recon = [recon for _, _, recon in frames]
        self._dpb.append([self._dpb_entry(recon) for recon in self.recon])
        if len(self._dpb) > max(self.n_refs, 1):
            self._dpb.pop(0)
        words_h = to_host(torch.stack([w for w, _, _ in frames]),
                          "slice_words").numpy()
        bits_h = to_host(torch.stack([torch.as_tensor(b)
                                      for _, b, _ in frames]), "slice_bits")
        outs = []
        for s in range(self.S):
            sh = self._slice_header(ftype, n_ref_l0=n_ref)
            outs.append(intra.finalize_slice(self, words_h[s], int(bits_h[s]),
                                             self.cap_words, sh, ntype, ridc))
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.log2_max_frame_num)
        self.poc += 2
        return outs
