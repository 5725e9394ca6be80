"""The (stream, band) layout of x264_tpu/parallel/mesh.py on one torch
device: the re-expression of the reference's thread parallelism
(doc/threads.txt).

Mapping:
  * axis "stream": independent frames / streams (the encode-farm /
    frame-threads analogue).
  * axis "band": horizontal slice bands within a frame (the
    sliced-threads analogue). Each band is coded as an independent H.264
    slice, as x264's sliced threading does (threaded_slices_write,
    encoder.c:3219), and encoded as a frame of its own, so its top MB row
    reads no row above.

x264_tpu places the items on the devices of a JAX mesh. Here all
(stream, band) items run on one torch device: the I step's commits are
the items of ONE batched launch of the commit kernel (ops/commit.py), and
the P step, which carries no intra candidate, commits nothing. The other
stages run per item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..encoder import inter, intra
from ..ops import mc as mc_ops
from ..ops._cuda import to_host
from ..ops.commit import commit_batch
from ..ops.tables import chroma_qp

AXIS_NAMES = ("stream", "band")


@dataclass(frozen=True)
class Mesh:
    """A (stream, band) layout of items on one torch device."""
    shape: tuple
    device: torch.device
    axis_names: tuple = AXIS_NAMES

    @property
    def devices(self) -> np.ndarray:
        """The device of each (stream, band) item: one device throughout."""
        grid = np.empty(self.shape, dtype=object)
        grid.fill(self.device)
        return grid


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """(stream, band) layout of n items, factorised as x264_tpu's
    make_mesh does (band 4, else 2, else 1). `devices`: the one torch
    device (or its name) that runs every item; default cuda, which raises
    where there is no card."""
    if n_devices < 1:
        raise ValueError(f"need at least one item, got {n_devices}")
    band = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices > cand:
            band = cand
            break
    return Mesh((n_devices // band, band),
                resolve_device("cuda" if devices is None else devices))


def _band_items(planes_batch, band_mb_rows, device):
    """[y, u, v] frames -> per-plane [B * NB, band rows, width] tensors on
    `device`, item index stream * NB + band."""
    bh = band_mb_rows * 16
    out = []
    for c, rows in enumerate((bh, bh // 2, bh // 2)):
        stack = np.stack([f[c] for f in planes_batch])
        out.append(torch.from_numpy(np.ascontiguousarray(
            stack.reshape(-1, rows, stack.shape[-1]))).to(device))
    return out


def _unflatten(t, B, nb):
    return t.reshape((B, nb) + tuple(t.shape[1:]))


def _qp_maps(qp, band_mb_rows, mbw, device):
    qp_mb = np.full((band_mb_rows, mbw), qp, np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb), np.int32)
    return (torch.from_numpy(qp_mb).to(device),
            torch.from_numpy(qpc_mb).to(device))


def sharded_intra_encode(mesh: Mesh, planes_batch, qp: int = 26,
                         band_mb_rows: int = 2):
    """Encode a batch of frames split into slice bands; returns (words,
    total_bits, recon, satd), each leading [B, NB, ...] (recon: a (y, u, v)
    tuple). No deblock, as in x264_tpu. The bands' commits are one
    batched launch.

    planes_batch: list of [Y, U, V] numpy frames (equal MB-aligned
    sizes)."""
    dev = mesh.device
    B = len(planes_batch)
    H, W = planes_batch[0][0].shape
    nb = H // (band_mb_rows * 16)
    mbw = W // 16
    cap_words = mbw * band_mb_rows * 64
    ys, us, vs = _band_items(planes_batch, band_mb_rows, dev)
    qp_mb, qpc_mb = _qp_maps(qp, band_mb_rows, mbw, dev)
    modes = [intra.decide_iframe(y, u, v, qp_mb, i4=False)
             for y, u, v in zip(ys, us, vs)]
    committed = commit_batch([
        intra.iframe_commit_inputs(y, u, v, qp_mb, qpc_mb, m, mbw=mbw,
                                   mbh=band_mb_rows)
        for y, u, v, m in zip(ys, us, vs, modes)])
    outs = [intra.iframe_cavlc_tail(m, coeffs, recon, qp_mb, qp, mbw=mbw,
                                    mbh=band_mb_rows, cap_words=cap_words)
            for m, (coeffs, recon) in zip(modes, committed)]
    words = _unflatten(torch.stack([o[0] for o in outs]), B, nb)
    bits = _unflatten(torch.stack([torch.as_tensor(o[1]) for o in outs]),
                      B, nb)
    recon = tuple(_unflatten(torch.stack([o[2][c] for o in outs]), B, nb)
                  for c in range(3))
    satd = _unflatten(torch.stack([torch.as_tensor(o[3]) for o in outs]),
                      B, nb)
    return words, bits, recon, satd


def assemble_band_nals(params, band_words, band_bits, *, band_mb_rows: int,
                       slice_qp: int, frame_num: int = 0, poc: int = 0,
                       idr: bool = True, ptype: bool = False,
                       idr_pic_id: int = 0, deblock_idc: int = 1):
    """Host tail of a banded frame: each band's payload after its own
    slice header -> list of slice NALs (one per band), as x264's sliced
    threads write them (encoder.c:3219).

    band_words: [NB, cap_words] words; band_bits: [NB] totals (tensors
    on any device, or numpy). deblock_idc=2 codes 'filter inside slice
    only' (spec 7.4.3), matching the band-local deblock."""
    from ..entropy import nal as nal_mod
    from ..entropy import sets
    from ..entropy.bits import append_bitstring
    from ..entropy.cavlc_dev import words_to_bytes
    from ..entropy.slice_hdr import (SLICE_TYPE_I, SLICE_TYPE_P, SliceHeader,
                                     slice_header_write)
    if isinstance(band_words, torch.Tensor):
        band_words = to_host(band_words, "slice_words").numpy()
    if isinstance(band_bits, torch.Tensor):
        band_bits = to_host(band_bits, "slice_bits").numpy()
    sps = sets.sps_init(params, params.sps_id)
    pps = sets.pps_init(params, sps, params.sps_id)
    mbw = params.mb_width
    mbs_per_band = band_mb_rows * mbw
    nals = []
    nb = len(band_bits)
    for b in range(nb):
        sh = SliceHeader(sps=sps, pps=pps)
        sh.slice_type = SLICE_TYPE_P if ptype else SLICE_TYPE_I
        sh.first_mb = b * mbs_per_band
        sh.last_mb = sh.first_mb + mbs_per_band - 1
        sh.frame_num = frame_num
        sh.idr = idr
        sh.idr_pic_id = idr_pic_id
        sh.poc_lsb = poc % (1 << sps.log2_max_poc_lsb)
        sh.qp = slice_qp
        if ptype:
            sh.num_ref_idx_l0_active = 1
            sh.num_ref_idx_override = pps.num_ref_idx_l0_active != 1
        sh.disable_deblocking_filter_idc = deblock_idc
        total_bits = int(band_bits[b])
        n_words = (total_bits + 31) // 32
        payload, nbits = words_to_bytes(np.asarray(band_words[b][:n_words]),
                                        total_bits)
        ref_idc = (nal_mod.NAL_PRIORITY_HIGHEST if idr
                   else nal_mod.NAL_PRIORITY_HIGH)
        bw = slice_header_write(sh, ref_idc)
        append_bitstring(bw, payload, nbits)
        bw.rbsp_trailing()
        ntype = nal_mod.NAL_SLICE_IDR if idr else nal_mod.NAL_SLICE
        nals.append(nal_mod.nal_encode(ntype, ref_idc, bw.getvalue()))
    return nals


def sharded_pframe_encode(mesh: Mesh, planes_batch, refs_batch, qp: int = 26,
                          band_mb_rows: int = 2, me_range: int = 8):
    """Encode B P frames (one per stream) against per-stream references,
    each split into NB slice bands; returns (words, total_bits, recon,
    stats), each leading [B, NB, ...] (stats: a dict of the per-band
    counts).

    Each band's reference is its window of the padded reference expanded
    by the halo (PAD rows above and below), so that the band-local motion
    search may reach across band edges, as x264's sliced threads share the
    reference picture. The band step is x264_tpu's: no intra candidate
    (so no commit), 16x16 only, the exhaustive search, one reference, and
    the deblock inside the band.

    refs_batch: list of [Y, U, V] reconstructions (shapes as planes)."""
    dev = mesh.device
    B = len(planes_batch)
    H, W = planes_batch[0][0].shape
    nb = H // (band_mb_rows * 16)
    mbw = W // 16
    bh = band_mb_rows * 16
    cap_words = mbw * band_mb_rows * 128
    ys, us, vs = _band_items(planes_batch, band_mb_rows, dev)
    # each reference padded and its half-pel planes built once on the
    # device, as a DPB push builds them; each band takes its window (band
    # rows +- PAD, full width + PAD)
    PAD, CPAD = mc_ops.PAD, mc_ops.CPAD
    refs = []
    for f in refs_batch:
        y, u, v = (torch.as_tensor(p, device=dev) for p in f)
        y_pad = mc_ops.pad_plane(y)
        hp = mc_ops.hpel_planes(y_pad)
        cuv = torch.stack([mc_ops.pad_plane(u, CPAD),
                           mc_ops.pad_plane(v, CPAD)])
        for b in range(nb):
            r0, c0 = b * bh, b * bh // 2
            refs.append({
                "y_pad": y_pad[r0:r0 + bh + 2 * PAD].contiguous(),
                "hpel": hp[:, r0:r0 + bh + 2 * PAD].contiguous(),
                "cuv_pad": cuv[:, c0:c0 + bh // 2 + 2 * CPAD].contiguous()})
    qp_mb, qpc_mb = _qp_maps(qp, band_mb_rows, mbw, dev)
    lam = max(1, int(round(2.0 ** ((qp - 12) / 6.0))))
    outs = [inter.encode_pframe(
        y, u, v, [ref], qp_mb, qpc_mb, qp, lam, None, mbw=mbw,
        mbh=band_mb_rows, cap_words=cap_words, me_range=me_range,
        deblock=True, a_off=0, b_off=0, cqpo=0, decimate=True, i4=False,
        two_refs=False, p8x8=False, me_seeded=False, partitions=False,
        rd=False, intra_in_p=False)
        for y, u, v, ref in zip(ys, us, vs, refs)]
    words = _unflatten(torch.stack([o[0] for o in outs]), B, nb)
    bits = _unflatten(torch.stack([torch.as_tensor(o[1]) for o in outs]),
                      B, nb)
    recon = tuple(_unflatten(torch.stack([o[2][c] for o in outs]), B, nb)
                  for c in range(3))
    stats = {k: _unflatten(torch.stack([torch.as_tensor(o[3][k])
                                        for o in outs]), B, nb)
             for k in ("skip", "intra", "satd")}
    return words, bits, recon, stats
