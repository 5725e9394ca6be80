"""How `correct` is decided: the frames the window's encode calls put out,
decoded by the plain reference decoder (reference/decoder.py) from their
NAL units and compared with the encoder's reconstructions.

What it judges is the port's output itself: the stream the entropy layer
wrote (device CAVLC, or the trellis and the host CABAC writer), the QP
that rate control gave each frame (the slice QP the stream carries
against PicOut.qp), and the reconstruction (commit, deblock and the
motion-compensated prediction from the motion kernels' vectors), which
the decoder has to reproduce sample for sample, the padding rows and
columns included. It decodes a sample drawn from the seed, since a
1080p frame takes the NumPy decoder seconds:

1. `check_frames` frames in coding order from a P or I frame drawn among
   the window's frames;
2. when the window coded B frames and (1) decoded none: a drawn anchor
   that a B frame follows, then that B frame;
3. when the quality frames hold an I frame and (1)-(2) decoded none: the
   first of them.

A segment starts from the state a decoder of the whole stream would hold:
its DPB is the encoder's reconstructions of the (at most two) reference
frames before the segment, found by following frame_num, POC and the
sliding window through every slice header since the first IDR. What the
segment's first frame predicts from is therefore taken from the program,
and checked where the sample decodes that frame itself.

Each number has the limit 0 (an exact comparison):
  mismatched_samples  samples (Y, U, V) where decoder and encoder differ
  qp_mismatch         decoded frames whose slice QP is not PicOut.qp
  undecoded_frames    sampled frames the decoder could not decode
  lost_frames         frames pushed less frames output less those the
                      encoder still holds
  unsampled           1 when the window output no frame to check
"""

from __future__ import annotations

import random

import numpy as np

from portbench.reference import decoder as D

LIMITS = {"mismatched_samples": 0, "qp_mismatch": 0, "undecoded_frames": 0,
          "lost_frames": 0, "unsampled": 0}


def _slice_nal(nals):
    for n in nals:
        if n[0] & 0x1F in (1, 5):
            return n
    raise ValueError("a coded frame without a slice NAL")


def headers_walk(headers, coded):
    """Per coded frame: its header start (slice_header_start), POC, and the
    DPB (indices into `coded`) and POC state a decoder holds before it."""
    dec = D.Decoder()
    for h in headers:
        dec.decode_nal(h)
    sps = dec.sps
    walk, dpb, prev = [], [], (0, 0)
    for i, fr in enumerate(coded):
        h = D.slice_header_start(_slice_nal(fr["nals"]), sps)
        if h["idr"]:
            dpb, prev = [], (0, 0)
        h["dpb"], h["prev"] = list(dpb), prev
        poc, msb = D.poc_step(h["poc_lsb"], prev[0], prev[1],
                              sps.log2_max_poc_lsb)
        h["poc"] = poc
        if h["ref_idc"]:
            prev = (h["poc_lsb"], msb)
            dpb = (dpb + [i])[-2:]
        walk.append(h)
    return walk


def segments(coded, lo, hi, quality, seed, k):
    """The sample: [(start, stop)] ranges of coding-order indices."""
    rng = random.Random(seed)
    anchors = [i for i in range(lo, hi) if coded[i]["type"] != "B"]
    if not anchors:
        return []
    s = rng.choice(anchors)
    segs = [(s, min(s + k, len(coded)))]
    types = {coded[i]["type"] for i in range(*segs[0])}
    bs = [i for i in anchors if i + 1 < len(coded)
          and coded[i + 1]["type"] == "B"]
    if "B" not in types and bs:
        a = rng.choice(bs)
        segs.append((a, a + 2))
        types.add("B")
    intra = [i for i in sorted(quality) if coded[i]["type"] == "I"]
    if "I" not in types and intra:
        segs.append((intra[0], intra[0] + 1))
    return segs


def decode_segment(headers, coded, walk, start, stop):
    """Decode coded[start:stop] from the DPB before `start`. Returns
    [(index, (y, u, v) uncropped int64, slice QP)] of what decoded, and
    the number of frames that did not."""
    dec = D.Decoder()
    for h in headers:
        dec.decode_nal(h)
    w = walk[start]
    refs = [{"poc": walk[j]["poc"], "fn": walk[j]["fn"],
             "planes": tuple(p.cpu().numpy().astype(np.int64)
                             for p in coded[j]["recon"])}
            for j in w["dpb"]]
    dec.seed(refs, *w["prev"])
    out = []
    for i in range(start, stop):
        try:
            for n in coded[i]["nals"]:
                dec.decode_nal(n)
        except Exception as e:      # a stream it cannot decode is a verdict
            return out, stop - i, f"frame {i}: {type(e).__name__}: {e}"
        out.append((i, dec.full_frames[-1], dec.slice_qps[-1]))
    return out, 0, None


def compare(headers, coded, lo, hi, quality, seed, k, lost):
    """The verdict on the frames coded[lo:hi] (the window's; `quality`
    the indices of the quality frames): {"correct", "failed" (frames that
    failed), "numbers" {name: {value, limit}}, "decoded" [indices]}."""
    walk = headers_walk(headers, coded)
    segs = segments(coded, lo, hi, quality, seed, k)
    mism = qpm = undec = failed = 0
    decoded, errors = [], []
    for start, stop in segs:
        got, n_bad, err = decode_segment(headers, coded, walk, start, stop)
        undec += n_bad
        failed += n_bad
        if err:
            errors.append(err)
        for i, planes, qp in got:
            want = [p.cpu().numpy() for p in coded[i]["recon"]]
            bad = sum(int((a != b.astype(np.int64)).sum())
                      for a, b in zip(planes, want))
            mism += bad
            qpm += int(qp != coded[i]["qp"])
            failed += int(bad > 0 or qp != coded[i]["qp"])
            decoded.append(i)
    numbers = {"mismatched_samples": mism, "qp_mismatch": qpm,
               "undecoded_frames": undec, "lost_frames": abs(int(lost)),
               "unsampled": int(not segs)}
    failed += abs(int(lost))
    return {"correct": all(numbers[n] <= LIMITS[n] for n in LIMITS),
            "failed": failed, "decoded": decoded, "errors": errors,
            "numbers": {n: {"value": numbers[n], "limit": LIMITS[n]}
                        for n in LIMITS}}
