"""Rate control: CQP / CRF / ABR + frame-level VBV + 2-pass (reference
encoder/ratecontrol.c, 3134 LoC; doc/ratecontrol.txt).

Frame-level control with the reference's qscale model —
qscale = blurred_complexity^(1-qcompress) / rate_factor — driven by the
device-computed frame SATD cost, with ABR buffer feedback.

VBV (reference ratecontrol.c:2137 update_vbv / clip_qscale): a bit
predictor (bits ~ coef*complexity/qscale, reference predict_size
ratecontrol.c:2109) clamps each frame's qscale so the predicted size fits
the decoder buffer; the buffer state integrates actual sizes.

2-pass (reference ratecontrol.c:744 stat parse, init_pass2
ratecontrol.c:2932): pass 1 logs per-frame {type, qp, satd, bits}; pass 2
solves for the rate factor that hits the bit budget under the
bits ~ c*cplx^qcomp model and schedules per-frame QPs, with an ABR-style
feedback term correcting drift against the actual bits spent.

Under the frame pipeline the state updates lag one frame, exactly like
the reference's frame-thread RC sync (x264_thread_sync_ratecontrol,
ratecontrol.c:2754).

The port's own copy of `x264_tpu/encoder/ratecontrol.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

import math

from .. import params as P
from .encoder import TYPE_B, TYPE_BREF, TYPE_I, TYPE_IDR, TYPE_P


def qp2qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale2qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


class RateControl:
    """Frame-level rate control state (reference x264_ratecontrol_t)."""

    def __init__(self, p: P.Params) -> None:
        self.p = p
        self.method = p.rc.rc_method
        self.qcomp = p.rc.qcompress
        self.fps = p.fps_num / max(1, p.fps_den)
        self.bitrate = p.rc.bitrate * 1000.0
        # complexity blur state (reference rate_estimate_qscale)
        self.cplx_sum = 0.0
        self.cplx_count = 0.0
        self.total_bits = 0.0
        self.frames = 0
        self.last_rceq = 1.0
        # per-MB full-res SATD calibration constant (reference uses
        # mb_count*(80|120) against half-res lowres costs; our frame cost
        # is full-res, ~4x)
        self.base_cplx = p.mb_width * p.mb_height * (
            480 if p.bframe else 320)
        if self.method == P.RC_CRF:
            self.rate_factor = (self.base_cplx ** (1.0 - self.qcomp)
                                / qp2qscale(p.rc.rf_constant))
        else:
            self.rate_factor = 1.0
        # ABR state (reference ratecontrol_new ABR init)
        self.cplxr_sum = (0.01 * (7.0e5 ** self.qcomp)
                          * (p.mb_width * p.mb_height) ** 0.5)
        self.wanted_bits_window = max(self.bitrate / max(self.fps, 1.0),
                                      1.0)
        self.cbr_decay = 1.0

        # ---- VBV state (reference ratecontrol.c:2137) ----
        rc = p.rc
        self.vbv = bool(rc.vbv_buffer_size and rc.vbv_max_bitrate)
        self._cbr = p.nal_hrd == P.NAL_HRD_CBR
        if self.vbv:
            self.buffer_size = rc.vbv_buffer_size * 1000.0
            self.buffer_rate = rc.vbv_max_bitrate * 1000.0 / max(self.fps,
                                                                 1.0)
            self.buffer_fill = self.buffer_size * min(
                max(rc.vbv_buffer_init, 0.0), 1.0)
            # bit predictor per frame type: bits ~ coef * cplx / qscale
            self.pred_coef = {k: 0.5 for k in "IPB"}
            self.pred_count = {k: 1.0 for k in "IPB"}

        # ---- 2-pass state ----
        self.started = 0
        self.stat_lines: list[str] = []
        self.pass2 = []                 # per-frame scheduled (type, qp)
        self.pass2_expected = []        # cumulative expected bits
        if rc.stat_read:
            self._init_pass2()

    @staticmethod
    def _tkey(ftype: int) -> str:
        return {TYPE_IDR: "I", TYPE_I: "I", TYPE_P: "P",
                TYPE_B: "B", TYPE_BREF: "B"}[ftype]

    # -------------------------------------------------------------- 2-pass
    def _init_pass2(self) -> None:
        """Parse the pass-1 stat file and schedule per-frame QPs
        (reference init_pass2, ratecontrol.c:2932)."""
        rc = self.p.rc
        recs = []
        with open(rc.stat_in) as f:
            for line in f:
                parts = dict(kv.split(":", 1) for kv in line.split()
                             if ":" in kv)
                if "type" not in parts:
                    continue
                recs.append((parts["type"], float(parts["q"]),
                             float(parts["tex"]), float(parts["bits"])))
        if not recs:
            raise ValueError("empty 2-pass stats file")
        # calibrate the bits ~ c * cplx^qcomp * (1/ipb) model from pass 1
        csum = ccount = 0.0
        for t, q, cplx, bits in recs:
            qs = qp2qscale(q)
            csum += bits * qs / max(cplx, 1.0)
            ccount += 1
        c = csum / max(ccount, 1.0)
        target_total = self.bitrate / self.fps * len(recs)

        def total_for(rf: float) -> float:
            tot = 0.0
            for t, _, cplx, _ in recs:
                qs = max(cplx, 1.0) ** (1.0 - self.qcomp) / rf
                if t == "I":
                    qs /= rc.ip_factor
                elif t == "B":
                    qs *= rc.pb_factor
                qs = min(max(qs, qp2qscale(rc.qp_min)),
                         qp2qscale(rc.qp_max))
                tot += c * max(cplx, 1.0) / qs
            return tot

        lo, hi = 1e-6, 1e9
        for _ in range(60):             # bisection on the rate factor
            mid = math.sqrt(lo * hi)
            if total_for(mid) > target_total:
                lo, hi = lo, mid
            else:
                lo, hi = mid, hi
        rf = math.sqrt(lo * hi)
        cum = 0.0
        for t, _, cplx, _ in recs:
            qs = max(cplx, 1.0) ** (1.0 - self.qcomp) / rf
            if t == "I":
                qs /= rc.ip_factor
            elif t == "B":
                qs *= rc.pb_factor
            qp = min(max(qscale2qp(qs), rc.qp_min), rc.qp_max)
            self.pass2.append((t, qp))
            cum += c * max(cplx, 1.0) / min(max(qs, qp2qscale(rc.qp_min)),
                                            qp2qscale(rc.qp_max))
            self.pass2_expected.append(cum)

    def write_stats(self) -> None:
        """Flush pass-1 stats (reference ratecontrol_end stat write)."""
        if self.p.rc.stat_write and self.stat_lines:
            path = self.p.rc.stat_out
            with open(path, "w") as f:
                f.write("".join(self.stat_lines))
        self.mbtree_flush()

    # --------------------------------------------------- MB-tree stats file
    # Reference: binary fix8-packed per-MB qp offsets appended per frame
    # (mbtree_fix8_pack/unpack mc.h:338-339, x264_macroblock_tree_read
    # ratecontrol.c:541, cross-resolution rescale :417-540). File is
    # "<stats>.mbtree": u32 frame count header-less stream of records
    # [u32 idx, u16 mbh, u16 mbw, int16 fix8 offsets (mbh*mbw)].

    def _mbtree_path(self, write: bool):
        rc = self.p.rc
        base = rc.stat_out if write else rc.stat_in
        return (base + ".mbtree") if base else None

    def mbtree_record(self, idx: int, tree_off) -> None:
        """Pass-1: remember a frame's MB-tree qp offsets for the file."""
        if not self.p.rc.stat_write or tree_off is None:
            return
        import numpy as _np
        a = _np.asarray(tree_off, _np.float32)
        self._mbtree_recs = getattr(self, "_mbtree_recs", [])
        self._mbtree_recs.append((idx, a))

    def mbtree_flush(self) -> None:
        path = self._mbtree_path(True)
        recs = getattr(self, "_mbtree_recs", None)
        if not path or not recs:
            return
        import struct
        import numpy as _np
        with open(path, "wb") as f:
            for idx, a in recs:
                fix8 = _np.clip(_np.round(a * 256.0), -32768,
                                32767).astype("<i2")
                f.write(struct.pack("<IHH", idx, a.shape[0], a.shape[1]))
                f.write(fix8.tobytes())

    def mbtree_fetch(self, idx: int):
        """Pass-2: stored offsets for frame idx, rescaled to the current
        MB grid when resolutions differ (ratecontrol.c:417-540)."""
        if not self.pass2:
            return None
        if not hasattr(self, "_mbtree_in"):
            self._mbtree_in = {}
            path = self._mbtree_path(False)
            if path:
                import os as _os
                import struct
                import numpy as _np
                if _os.path.exists(path):
                    with open(path, "rb") as f:
                        while True:
                            hdr = f.read(8)
                            if len(hdr) < 8:
                                break
                            fi, mh, mw = struct.unpack("<IHH", hdr)
                            raw = f.read(mh * mw * 2)
                            a = _np.frombuffer(raw, "<i2").astype(
                                _np.float32).reshape(mh, mw) / 256.0
                            self._mbtree_in[fi] = a
        a = self._mbtree_in.get(idx)
        if a is None:
            return None
        mh = self.p.mb_height
        mw = self.p.mb_width
        if a.shape != (mh, mw):
            import numpy as _np
            ys = _np.clip((_np.arange(mh) * a.shape[0]) // max(mh, 1), 0,
                          a.shape[0] - 1)
            xs = _np.clip((_np.arange(mw) * a.shape[1]) // max(mw, 1), 0,
                          a.shape[1] - 1)
            a = a[ys][:, xs]
        return a

    # ----------------------------------------------------------------- VBV
    def set_lookahead_costs(self, costs) -> None:
        """Planned lowres costs of the queued frames (display order) —
        feeds the VBV lookahead simulation (reference vbv_lookahead,
        slicetype.c:1225 + clip_qscale's planned loop,
        ratecontrol.c:2279-2330)."""
        self._la_costs = list(costs or [])

    def _clip_qscale_vbv(self, tkey: str, qscale: float) -> float:
        """Raise qscale until the predicted frame fits the buffer
        (reference clip_qscale, ratecontrol.c:2244), simulating buffer
        evolution over the lookahead window's planned frames so a burst
        of expensive upcoming frames raises QP before the underflow."""
        cplx = (self.cplx_sum / self.cplx_count
                if self.cplx_count > 0 else float(self.base_cplx))
        coef = self.pred_coef[tkey] / self.pred_count[tkey]
        coef_p = self.pred_coef["P"] / self.pred_count["P"]
        la = getattr(self, "_la_costs", [])[:16]
        for _ in range(32):
            pred = coef * cplx / max(qscale, 1e-9)
            # keep at least 20% of the buffer after this frame when
            # possible (reference keeps space for subsequent frames)
            space = self.buffer_fill + self.buffer_rate \
                - 0.2 * self.buffer_size
            under = pred > max(space, self.buffer_rate * 0.5)
            if not under and la:
                # VBV lookahead: walk the planned window at this qscale
                fill = self.buffer_fill + self.buffer_rate - pred
                for c in la:
                    fill = min(fill + self.buffer_rate,
                               self.buffer_size)
                    fill -= coef_p * max(c, 1.0) / max(qscale, 1e-9)
                    if fill < 0.1 * self.buffer_size:
                        under = True
                        break
            if not under or qscale >= qp2qscale(self.p.rc.qp_max):
                break
            qscale *= 1.1
        return qscale

    # ----------------------------------------------------------------- HRD
    def hrd_fullness(self, bitrate: int, cpb_size: int):
        """initial_cpb_removal_delay (+offset) in 90 kHz ticks from the
        current decoder-buffer fill (reference x264_hrd_fullness,
        ratecontrol.c:2194). `bitrate`/`cpb_size` are the values a
        decoder reconstructs from the scaled VUI fields.

        Frame-level approximation: buffer_fill is the decoder CPB state
        after the previous frame's removal + refill, which is exactly
        the fullness a new buffering period should advertise."""
        fill = min(self.buffer_fill if self.vbv else float(cpb_size),
                   float(cpb_size))
        delay = int(90000 * fill / max(bitrate, 1))
        offset = int(90000 * cpb_size / max(bitrate, 1)) - delay
        lim = (1 << 24) - 1
        return min(delay, lim), max(0, min(offset, lim))

    def hrd_filler_bits(self) -> int:
        """CBR overflow: bits of filler needed so the decoder buffer
        does not overflow (reference hrd_filler / update_vbv filler,
        ratecontrol.c:2137). Call after end(); returns whole bytes*8."""
        if not self.vbv or not getattr(self, "_cbr", False):
            return 0
        over = self.buffer_fill - self.buffer_size
        if over <= 0:
            return 0
        nbytes = int(over + 7) // 8
        self.buffer_fill -= nbytes * 8
        return nbytes * 8

    # ------------------------------------------------------------- zones
    def _zone_for(self, frame_idx):
        """Zone covering display frame `frame_idx` (reference
        get_zone, ratecontrol.c:1219-1343); later zones win."""
        if frame_idx is None:
            return None
        z_hit = None
        for z in self.p.rc.zones:
            if z.start <= frame_idx <= z.end:
                z_hit = z
        return z_hit

    # ------------------------------------------------------------- frame
    def start(self, ftype: int, forced_qp: int = -1,
              frame_idx: int = None) -> int:
        """QP for the upcoming frame (reference x264_ratecontrol_start).
        frame_idx is the display-order index (zone lookup)."""
        rc = self.p.rc
        idx = getattr(self, "started", 0)
        self.started = idx + 1
        if forced_qp >= 0:
            return forced_qp
        zone = self._zone_for(frame_idx)
        if zone is not None and zone.force_qp:
            return int(min(max(zone.force_qp, rc.qp_min), rc.qp_max))
        if self.pass2:
            t, qp = self.pass2[min(idx, len(self.pass2) - 1)]
            # drift correction vs the pass-2 plan (reference vbv_pass2 /
            # ABR-style feedback, ratecontrol.c:2868)
            if idx > 0:
                expected = self.pass2_expected[
                    min(idx - 1, len(self.pass2_expected) - 1)]
                drift = (self.total_bits - expected) / max(
                    2.0 * rc.rate_tolerance * self.bitrate, 1.0)
                qp += min(max(6.0 * drift, -4.0), 4.0)
            qp = min(max(qp, rc.qp_min), rc.qp_max)
            if self.vbv:
                tkey = self._tkey(ftype)
                qp = qscale2qp(self._clip_qscale_vbv(tkey, qp2qscale(qp)))
                qp = min(max(qp, rc.qp_min), rc.qp_max)
            return int(round(qp))
        if self.method == P.RC_CQP:
            q = rc.qp_constant
            if ftype in (TYPE_IDR, TYPE_I):
                q = int(round(q - 6.0 * math.log2(rc.ip_factor)))
            elif ftype in (TYPE_B, TYPE_BREF):
                q = int(round(q + 6.0 * math.log2(rc.pb_factor)))
            if zone is not None:
                q = int(round(q - 6.0 * math.log2(zone.bitrate_factor)))
            return int(min(max(q, rc.qp_min), rc.qp_max))

        blurred = (self.cplx_sum / self.cplx_count
                   if self.cplx_count > 0 else float(self.base_cplx))
        self.last_rceq = blurred ** (1.0 - self.qcomp)
        if self.method == P.RC_ABR:
            rate_factor = self.wanted_bits_window / self.cplxr_sum
        else:
            rate_factor = self.rate_factor
        qscale = self.last_rceq / max(rate_factor, 1e-9)

        if self.method == P.RC_ABR and self.frames > 0:
            # overflow compensation (reference rate_estimate_qscale ABR)
            wanted = self.bitrate / self.fps * self.frames
            abr_buffer = 2.0 * rc.rate_tolerance * self.bitrate
            overflow = min(max(
                1.0 + (self.total_bits - wanted) / max(abr_buffer, 1.0),
                0.5), 2.0)
            qscale *= overflow

        if ftype in (TYPE_IDR, TYPE_I):
            qscale /= rc.ip_factor
        elif ftype in (TYPE_B, TYPE_BREF):
            qscale *= rc.pb_factor
        if zone is not None:
            qscale /= zone.bitrate_factor   # ratecontrol.c zone apply

        if self.vbv:
            qscale = self._clip_qscale_vbv(self._tkey(ftype), qscale)
        qp = qscale2qp(max(qscale, 1e-4))
        qp = min(max(qp, rc.qp_min), rc.qp_max)
        self._pending_qscale = qp2qscale(qp)
        return int(round(qp))

    def end(self, ftype: int, bits: int, satd_cost: float,
            qp_used: int) -> None:
        """Post-frame update (reference x264_ratecontrol_end)."""
        tkey = self._tkey(ftype)
        if self.p.rc.stat_write:
            self.stat_lines.append(
                f"in:{self.frames} out:{self.frames} type:{tkey} "
                f"q:{qp_used:.2f} tex:{float(satd_cost):.0f} "
                f"bits:{bits}\n")
        if self.vbv:
            cplx = max(float(satd_cost), 1.0)
            qs = qp2qscale(qp_used)
            # update the size predictor (reference update_predictor)
            self.pred_coef[tkey] = (self.pred_coef[tkey] * 0.5
                                    + bits * qs / cplx)
            self.pred_count[tkey] = self.pred_count[tkey] * 0.5 + 1.0
            # CBR keeps the overflow visible so hrd_filler_bits() can
            # convert it to filler; VBR arrival just stalls (clamp)
            self.buffer_fill += self.buffer_rate - bits
            if not self._cbr:
                self.buffer_fill = min(self.buffer_fill, self.buffer_size)
            self.buffer_fill = max(self.buffer_fill, 0.0)
        if self.method == P.RC_CQP and not self.pass2:
            if self.p.rc.stat_write:
                self.frames += 1
            return
        satd = max(float(satd_cost), 1.0)
        self.cplx_sum = self.cplx_sum * 0.5 + satd
        self.cplx_count = self.cplx_count * 0.5 + 1.0
        self.total_bits += bits
        self.frames += 1
        if self.method == P.RC_ABR:
            # undo the I/B qscale offsets so the model tracks P-equivalents
            qscale = qp2qscale(qp_used)
            if ftype in (TYPE_IDR, TYPE_I):
                qscale *= self.p.rc.ip_factor
            elif ftype in (TYPE_B, TYPE_BREF):
                qscale /= self.p.rc.pb_factor
            self.cplxr_sum = (self.cplxr_sum * self.cbr_decay
                              + bits * qscale / max(self.last_rceq, 1e-9))
            self.wanted_bits_window = (
                self.wanted_bits_window * self.cbr_decay
                + self.bitrate / self.fps)
