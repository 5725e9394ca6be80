#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x264_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --commit-ab OTHER_CHECKOUT   (see ab)
    python3 chip_smoke.py --motion-ab OTHER_CHECKOUT   (see ab)
    python3 chip_smoke.py --cavlc                      (see cavlc_only)

Phases, in the order 1, 8, 2, 4, 5, 7, 9, 10, 6 (the timed work, with
nothing else running but the default path's decoder, at the lowest
priority on one core), then 3 (it times nothing) and the report (any
failure exits non-zero, stops every process the run started and prints
no result line):
  1. build the hand-written CUDA kernels (csrc/commit.cu, csrc/deblock.cu,
     csrc/motion.cu and csrc/cavlc.cu, one nvcc each, sm_90a, linked into
     one library)
     and print what ptxas reports; build and load the host CABAC writer
     (csrc/cabac.cpp, g++) beside them, all compilers started together;
     set the integer peak from the card (SMs x 128 lane instructions a
     clock x nvidia-smi's clocks.max.sm) and print the ESA's innermost
     __vsadu4 loop from the library's SASS (cuobjdump -sass);
  2. hold the frame kernel (one persistent launch per frame) against its
     plain PyTorch version (commit_ref) on the card, bit-exact (tolerance
     0: every output is an integer), in the I16, I16+I4, mixed + I_4x4
     and mixed (without I_4x4) variants, at 64x48, 48x32, 1920x1088 and a
     tall frame whose MB rows outnumber the blocks the card holds at once
     (so blocks loop over rows), and at 1920x1088 with 7 blocks; hold the
     mixed + I_4x4 variant against commit_ref on a real P frame (the
     arguments of the commit that the encoder's dispatch of the 1080p
     clip's frame 1, against frame 0's reconstruction, makes at preset
     medium), the mixed variant on the same frame at preset ultrafast,
     and time both; hold the
     first port's per-diagonal kernel
     against commit_ref too; time both kernels in turns (old, new, new,
     old) and commit_ref; split the per-diagonal kernel's time into
     launch cost and work; time the frame kernel's MB step and row
     hand-off on one-row and one-column frames; read its per-block
     counters (wait, luma, chroma, polling) at 1080p; then the batched
     launch (a leading item axis: B frames, or B slice bands, in one
     launch): B = 2 and 3 at 64x48 and 48x32 in the four variants and a
     batch whose B * mbh exceeds the co-resident grid, against commit_ref
     item by item; B = 2 real 1080p frames in the four variants against
     single launches; a 1080p frame as 4 bands of 17 MB rows (the mesh's
     I step) against commit_ref, timed; S = 1, 2, 4 1080p frames in one
     launch against S single launches, timed in turns; then the deblock
     kernel (csrc/deblock.cu, one persistent launch per frame, blocks of
     several MB rows in the phased schedule) against its plain version
     (deblock_ref) on the card, bit-exact, its inputs left as they were:
     intra and random strengths with per-MB QPs over 0-51 and a_off /
     b_off / chroma_qp_offset at -12, 0 and +12 at 64x48, 48x32, 16x16,
     16x64, 128x16, 16x80, 16x32 and 32x208 (one block walking every band
     too); at 1920x1088 the I frame with intra strengths (all blocks, and
     7 blocks that each walk several bands), random strengths, the real P
     frame 1 at preset medium (compute_strengths, two references) and the
     default path's first B frame (compute_strengths_b), both as the
     encoder called the deblock; the P and the I frame timed in turns
     with the kernel, the first port's kernel (one warp per MB row) and
     the kernel at 1, 2, 4 and 8 MB rows per block, each output equal to
     deblock_ref's, beside deblock_ref, their chains of MB steps and
     their bounds; then the motion kernels (csrc/motion.cu: the seeded
     search's half-res scan and refine, the ESA, the qpel refine) against
     their plain versions (ops/motion.py lowres_scan_plain,
     fullpel_plain, subpel_plain) and each public search through them
     against its sequential plain version (*_ref), bit-exact, on 48x32
     tie cases (flat, period-4 texture, lam 0 and 200, me_range 4, 16
     and 24, the PIR cap; 1, 5 and 9 qpel lanes), on the mapping's
     branch cases (qpel lane MVs equal to the 16x16 lane's, copied and
     distinct, windows past each plane edge, 1, 5 and 9 lanes, partition
     masks and random weights; full-pel windows past each edge; the
     inputs of tests/motion_branches.py), on the real calls
     of the 1080p clip's P frame 2 at preset medium (both references) and
     of the default path's first B frame (both lists), and the ESA at
     me_range 24 with every lane on P frame 2; the share of qpel (lane,
     4x4 block) pairs read from an earlier lane; each kernel timed on its
     real 1080p inputs beside its plain version and its bound, the qpel
     kernel at 9, 5 and 1 lanes, and each motion kernel's ptxas report
     (motion_phase); then the CAVLC residual coder kernel (csrc/cavlc.cu)
     against its plain version (residual_blocks_plain) on the cases of
     tests/cavlc_cases.py and on the five calls of a real 1080p ultrafast
     P frame's CAVLC writer, each of those timed beside the plain version
     and its byte bound, and its ptxas report (cavlc_phase); no kernel's
     bound may exceed its time;
  3. in a pool of worker processes (each with its own CUDA context),
     beside the decoders that the cases ask for: encode a 3-frame 64x48
     all-intra clip and a 5-frame 64x48 IPPP clip
     (preset medium, CAVLC) on CUDA and on the CPU: the streams must be
     byte-identical, and tools/refdec.py must decode each CUDA stream to
     its reconstruction; then the same CUDA == CPU check on 4 IPPP frames
     at 640x360; then all of it again with CABAC (trellis on): IPPP x5 at
     64x48 and x4 at 640x360 at CQP 26, and IPPP x5 at 64x48 at CRF 23
     with AQ (MB-tree off), the 64x48 streams through refdec; IBBP and
     the defaults; then veryfast, fast, noise reduction, periodic intra
     refresh (keyint 8, Encoder.intra_refresh() ahead of frame 1), I_PCM
     and SSIM at 64x48 x5 and 640x360 x3, refdec decoding the 640x360
     streams, the SSIM of each frame equal on both devices; then the
     modules ported last, CUDA == CPU byte for byte: the CLI
     (x264_tpu_torch.cli.main, --device cuda / cpu) at 64x48 to .264,
     .mkv and .mp4 at its defaults, with ABR + VBV + nal-hrd cbr + filler,
     with --aud, and two passes (stats files equal too); the farm (S = 2,
     one commit and two deblock launches per frame position) at 64x48 and
     640x360, refdec decoding the 640x360 streams to the farm's
     reconstructions; the mesh (2 streams x 4 bands, I then P) at 64x128,
     one commit launch for the I step and none for the P step, no deblock
     launch for the I step and 8 (one per band) for the P step, refdec
     decoding each intra band coded
     as a frame of its own (refdec decodes no multi-slice stream); and the
     CPU encodes of the timed paths' first frames (phases 4, 7, 8, 9, 10);
     and the deblock kernel on a frame whose bands of MB rows outnumber
     the blocks the card holds at once (2 MBs wide) against deblock_ref on
     the CPU; and IPPP x3 at 640x360 with --me tesa at me_range 24 (the
     ESA kernel at the presets' largest range, which must launch);
  Every path of phases 4-10 also resets the motion kernels' launch counts
  just before it runs and reads them just after: each must show launches
  of exactly the kernels it searches with (none on the all-intra path;
  the seeded search's two and the qpel refine on the P paths, the CLI
  and the farm; the ESA and the qpel refine on the mesh's P step; all
  four on the default path, whose B frames run the ESA); the CAVLC
  kernel's launches on phases 4, 5, 7, 8 and 9's paths are reported too.
  4. the all-intra path: 3 frames of the bench's 1080p clip (bench.py
     synth_clip; preset medium, keyint 1, CQP 26, CAVLC, deblock, I_4x4)
     through Encoder.encode on CUDA, with the kernels' launch counts reset
     just before and read just after (one commit launch per encoded
     frame, a deblock launch for every frame at least);
     frame 0 must match a CPU encode of the same frame byte for byte
     (phase 3);
  5. the P main path (what bench.py times): 4 frames of the same clip,
     IPPP at preset medium (2 references, weightp, partitions, subme 7,
     I_4x4 and intra in P), CQP 26, CAVLC, through Encoder.encode on
     CUDA, the launch count reset just before and read just after (one
     mixed + I_4x4 launch per P frame, one per I frame);
  7. the CABAC main path (bench.py's BD-rate sweep, make_params(26,
     cabac=True)): IDR + 3 P of the same clip through Encoder.encode on
     CUDA: the host C++ writer, trellis, no P_8x8; the launch count reset
     just before and read just after (one launch per frame); bytes beside
     phase 5's CAVLC bytes for the same frames; frame 0 must match a CPU
     encode of the same frame byte for byte (phase 3);
  8. the default path: 5 frames of the same clip at
     param_default_preset("medium") with only the size set (CRF 23, CABAC,
     bframe 3, MB-tree, AQ, trellis, 2 references, weightp), all decided
     at the flush (the MB-tree window is 24 frames deep), through
     Encoder.encode on CUDA. The adaptive B-run decision is asked first
     (the lookahead alone): if it would code no B frame on this clip, the
     phase runs with bframe_adaptive 0 and says so. The launch counts are
     reset just before and read just after: one commit launch per I or P
     frame, none for a B frame (it has no intra MB), and a deblock launch
     for every frame at least; the first B frame's deblock inputs are kept
     for phase 2 (one copy on the card). At least one frame
     must be B. Frame 0 must match a CPU encode of frame 0 (the CPU
     encoder's lookahead sees all 5 frames) byte for byte (phase 3);
     tools/refdec.py decodes the whole stream to the reconstructions,
     which takes minutes: the phase runs first, and the decoder, in a
     process of its own at the lowest priority on one core, runs beside
     every phase after it and is waited for after phase 3;
  9. the two ultrafast paths: 6 frames of the same clip at
     param_default_preset("ultrafast") with the size and CQP 26 (no
     deblock, no I_4x4, no partitions, subme 0: the I16 and the mixed
     variants without I_4x4), and 16 frames of it with intra refresh at
     keyint 8 (the sweep restarts at frame 8 and crosses the frame by
     frame 15: the mixed variant with a forced-intra column band), each
     through Encoder.encode with the launch counts reset just before and
     read just after (one commit per frame, no deblock: ultrafast does not
     deblock), frames 0-1 against a CPU encode of
     the same frames (phase 3), the band columns per frame, and a P-frame
     stage breakdown while the clip is encoded again;
 10. the farm, the mesh and the CLI at 1080p: the farm (S = 2: the
     bench's clip and the same clip mirrored, I P P at the farm's scope:
     preset medium IPPP, CQP 26, CAVLC, weighted_pred 0) with its stages
     timed, the launch counts reset just before and read just after (one
     commit and S = 2 deblocks per frame position); the mesh (1 stream x
     4 bands of 17 MB rows, I then P; one commit launch, then none; no
     deblock, then one per band); the CLI on a 6-frame y4m written by the
     port's Y4MWriter (preset ultrafast, ABR with VBV and nal-hrd cbr,
     .mp4; one commit launch per frame, no deblock), run again with its P
     stages timed, and
     its first two frames against a CPU run (phase 3); fps, launches,
     stage times, bytes and PSNR of each;
  6. print fps, the kernels' and the plain version's time per frame,
     per-stage breakdowns of a 1080p I frame and of a 1080p P frame with
     two references (the P path's own stage functions timed while
     Encoder.encode runs the clip again; its stream must equal phase
     5's), the same breakdown for the CABAC configuration (with the
     trellis, the decision packing, the device-to-host copy and the C++
     writer; its stream must equal phase 7's), the stages of a B frame of
     the default path (the two exhaustive searches, the two quarter-pel
     refines, direct, luma transform and trellis, chroma, decisions,
     deblock, the CABAC writer) and of its lookahead, timed the same way
     while the clip is encoded again (its stream must equal phase 8's),
     the device time per stage and device idle share under torch.profiler
     of the last P frame of each P breakdown (CAVLC, CABAC, ultrafast,
     intra refresh) and of a B frame, the kernel line, the card's name
     and power limit, and the result; fail if `jax` or any module of the
     `x264_tpu` package entered the process.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 2          # all-intra path
N_P_FRAMES = 4        # IPPP main path: IDR + 3 P (frames 2-3: two refs)
N_CABAC_FRAMES = 4    # CABAC main path: IDR + 3 P (frames 2-3: two refs)
N_DEFAULT_FRAMES = 5  # default path (I P B B B): fewer than the MB-tree
                      # window's 24
QP = 26
N_FAST_FRAMES = 6     # the 1080p ultrafast path: IPPPPP
N_PIR_FRAMES = 16     # ultrafast + intra refresh at keyint 8: a sweep in
                      # frames 8-15
# the commit kernel's variants in phase 2: (label, mixed, with_i4)
VARIANTS = (("i16", False, False), ("i16+i4", False, True),
            ("mixed+i4", True, True), ("mixed", True, False))


CHILDREN = []         # decoder processes and the worker pool, stopped by fail


def stop_children():
    for child in CHILDREN:
        if hasattr(child, "shutdown"):            # the phase 3 pool
            for proc in list((child._processes or {}).values()):
                proc.kill()
            child.shutdown(wait=False, cancel_futures=True)
        elif child.poll() is None:
            child.kill()
            child.wait()


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


MARKS = []            # (what ends here, host clock), printed in phase 6


def mark(name):
    """The work since the last mark was `name`."""
    MARKS.append((name, time.time()))


def phase_seconds():
    out = {}
    for (_, t0), (name, t1) in zip(MARKS, MARKS[1:]):
        out[name] = round(out.get(name, 0.0) + t1 - t0, 1)
    return out


def intra_params(w, h, qp=QP):
    from x264_tpu_torch import param_default_preset
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.keyint_max = 1
    p.cabac = False
    p.rc.rc_method = 0
    p.rc.qp_constant = qp
    return p


def ippp_params(w, h, qp=QP):
    """bench.py's timed configuration: preset medium with no B frames
    (IPPP, 2 references, weightp, partitions, subme 7), the default keyint,
    CQP, CAVLC."""
    p = intra_params(w, h, qp)
    p.keyint_max = 250
    p.bframe = 0
    return p


def cabac_params(w, h, qp=QP):
    """bench.py's BD-rate sweep, make_params(qp, cabac=True): ippp_params
    with the CABAC writer (so trellis 1 runs, and no P_8x8)."""
    p = ippp_params(w, h, qp)
    p.cabac = True
    return p


def crf_aq_params(w, h, rf=23.0):
    """IPPP CABAC at CRF with AQ (variance, the preset's strength); the
    MB-tree lookahead is off."""
    p = cabac_params(w, h)
    p.rc.rc_method = 1
    p.rc.rf_constant = rf
    p.rc.mb_tree = False
    return p


def ibbp_params(w, h, cabac, qp=QP):
    """Preset medium with a fixed run of 2 B frames (bframe_adaptive 0,
    spatial direct), CQP, CAVLC or CABAC."""
    p = intra_params(w, h, qp)
    p.keyint_max = 250
    p.bframe = 2
    p.bframe_adaptive = 0
    p.cabac = cabac
    return p


def default_params(w, h):
    """param_default_preset("medium") with only the size set: CRF 23,
    CABAC, bframe 3 with the fast adaptive B-run decision, MB-tree, AQ."""
    from x264_tpu_torch import param_default_preset
    p = param_default_preset("medium")
    p.width, p.height = w, h
    return p


def ultrafast_params(w, h, qp=QP, pir=False):
    """param_default_preset("ultrafast") with only the size and CQP set (no
    deblock, no I_4x4, no partitions, subme 0, one reference, no lookahead,
    no scene cut, CAVLC, no B frames); with pir, periodic intra refresh at
    keyint_max 8."""
    from x264_tpu_torch import param_default_preset
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.rc.rc_method = 0
    p.rc.qp_constant = qp
    if pir:
        p.intra_refresh = True
        p.keyint_max = 8
    return p


def preset_params(name):
    """make(w, h): param_default_preset(name) with only the size set."""
    def make(w, h):
        from x264_tpu_torch import param_default_preset
        p = param_default_preset(name)
        p.width, p.height = w, h
        return p
    return make


def option_params(**over):
    """make(w, h): ippp_params (preset medium, IPPP, CQP, CAVLC) with
    `over` set (a__b sets p.a.b)."""
    def make(w, h):
        p = ippp_params(w, h)
        for key, val in over.items():
            obj = p
            *path, last = key.split("__")
            for name in path:
                obj = getattr(obj, name)
            setattr(obj, last, val)
        return p
    return make


def pcm_params(w, h):
    """Preset ultrafast (no deblock) with only I_PCM frames."""
    p = ultrafast_params(w, h)
    p.force_pcm = True
    p.keyint_max = 1
    return p


def decided_types(params, frames, dev):
    """The frame types (coding order) the lookahead of an Encoder with
    `params` decides for `frames`, all pushed and then flushed: the
    lookahead alone, nothing is encoded."""
    from x264_tpu_torch.encoder.encoder import TYPE_IDR, Encoder, Picture
    enc = Encoder(params, device=dev)
    for i, f in enumerate(frames):
        enc._lookahead.push(enc._pad_to_mb(f), Picture(f, pts=i), i)
    types, keyframe = [], -(1 << 30)
    while True:
        decided = enc._lookahead.decide(keyframe, True)
        if not decided:
            return types
        for entry, ftype, _, _ in decided:
            if ftype == TYPE_IDR:
                keyframe = entry["idx"]
            types.append(ftype)


def moving_frames(n, w, h, seed=0):
    """A panning, noisy clip (tests/test_inter_e2e.py's moving_frames)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin((xx + 3 * i) / 17)
                    * np.cos((yy + 2 * i) / 13)
                    + rng.integers(-4, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin((xx[::2, ::2] + 3 * i) / 19), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos((yy[::2, ::2] - 2 * i) / 23), 0,
                    255).astype(np.uint8)
        out.append([y, u, v])
    return out


def encode_stream(enc, frames, picture, before=None):
    """Headers + frames (drained) -> (annex-B bytes, [PicOut]).
    before(enc, i), if given, runs ahead of the encode call of frame i."""
    from x264_tpu_torch.encoder.encoder import annexb_bytes
    stream = annexb_bytes(enc.headers())
    outs = []
    for i, f in enumerate(list(frames) + [None]):
        if before is not None and f is not None:
            before(enc, i)
        while True:
            nals, out = enc.encode(None if f is None else picture(f, pts=i))
            stream += annexb_bytes(nals)
            if out is not None:
                outs.append(out)
            if f is not None or out is None:
                break
    return stream, outs


def commit_inputs(torch, enc, planes, qp, seed, mixed, with_i4):
    """Main-path inputs of the commit: the frame's own mode decisions at
    the per-MB lambda; the mixed variant adds seeded intra flags and a
    stand-in inter reconstruction."""
    from x264_tpu_torch.encoder.frame_encode import build_qp_maps
    from x264_tpu_torch.encoder.intra import (decide_modes_full,
                                              decide_modes_i4, mb_lambda)
    y, u, v = planes
    qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp)
    lam = mb_lambda(qp_mb)
    i16, cm, _, c16 = decide_modes_full(y, u, v, lam=lam)
    kw = {}
    if with_i4:
        m4, c4 = decide_modes_i4(y, lam=lam)
        kw.update(i4_mask=(c4 < c16).contiguous(), i4_modes=m4.contiguous())
    if mixed:
        g = torch.Generator().manual_seed(seed)
        ia = torch.randint(0, 2, qp_mb.shape, generator=g).bool()
        ia = ia.to(y.device)
        if with_i4:
            ia = ia | kw["i4_mask"]
        kw["is_intra"] = ia.contiguous()
        kw["inter_planes"] = [torch.randint(0, 256, p.shape, generator=g,
                                            dtype=torch.uint8).to(y.device)
                              for p in planes]
    return (y, u, v, i16, cm, qp_mb, qpc_mb, enc.mb_w, enc.mb_h), kw


def max_abs_err(ref, got):
    errs = [(ref[0][k].long() - got[0][k].long()).abs().max().item()
            for k in ref[0]]
    errs += [(a.long() - b.long()).abs().max().item()
             for a, b in zip(ref[1], got[1])]
    return max(errs)


def cuda_ms(torch, fn, runs, prefill=False):
    """Mean device time per call (CUDA events around `runs` calls). With
    prefill the events wait behind ~10 ms of torch.cuda._sleep, so that
    the host has queued every call before the first starts and a call
    shorter than its host-side launch is timed on the card alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda.synchronize()
        torch.cuda._sleep(PREFILL_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def timed_ref(torch, C, args, kw):
    """commit_ref on these inputs -> (its outputs, its time in ms: one
    run, CUDA events around it)."""
    box = []
    ms = cuda_ms(torch, lambda: box.append(C.commit_ref(*args, **kw)), 1)
    return box[0], ms


PREFILL_CYCLES = 20_000_000     # ~10 ms of torch.cuda._sleep


def launch_split(torch, C, args, kw):
    """Split the per-diagonal kernel's time into launch cost and work:
    D launches (D = the frame's diagonal count) of an empty kernel and of
    one full diagonal (min(mbw, mbh) MBs, all-I16 and all-I4) through the
    same ctypes path. "host_paced": CUDA events around the launches as the
    host issues them; "device": the same after a torch.cuda._sleep that
    lets the host queue every launch first, so the events see the card's
    time alone. Returns microseconds per launch."""
    import ctypes
    lib = C._library()
    stream = torch.cuda.current_stream().cuda_stream
    mbw, mbh = args[7], args[8]
    n = C.n_diags(mbw, mbh)
    d = max(mbw, mbh) - 1

    def check(rc):
        if rc != 0:
            fail(f"launch failed: CUDA error {rc}")

    def per_launch_us(launch, prefill):
        torch.cuda.synchronize()
        if prefill:
            torch.cuda._sleep(PREFILL_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / n

    out = {"launches": n, "diagonal": d, "mbs_on_diagonal": min(mbw, mbh)}
    runs = [("empty", lambda: check(lib.x264t_empty_launch(stream)))]
    keep = []
    for label, all_i4 in (("diag_i16", False), ("diag_i4", True)):
        mask = torch.full_like(kw["i4_mask"], all_i4)
        bargs, bkw = C._as_batch(*args[:7], None, None, mask,
                                 kw["i4_modes"])
        struct, *tensors = C._kernel_args(*bargs, args[7], args[8], **bkw)
        keep.append((struct, tensors, mask))
        runs.append((label, lambda s=struct: check(
            lib.x264t_commit_diag(ctypes.byref(s), d, stream))))
    for label, launch in runs:
        per_launch_us(launch, False)                 # warm-up
        for mode, prefill in (("host_paced", False), ("device", True)):
            out[f"{label}_{mode}_us"] = [per_launch_us(launch, prefill)
                                         for _ in range(2)]
    return out


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
# The most integer instructions the card issues: each SM's four schedulers
# issue one warp instruction (32 lanes) a clock, 128 lane operations an SM
# a clock (the data sheet's 67e12 float32 /s counts a fused multiply-add
# as two). main sets it from the card's SM count and its maximum SM clock
# (nvidia-smi clocks.max.sm); the H100 SXM's 132 SMs at 1,980 MHz until
# then. Every count of operations below is the least instructions the
# work needs on this card.
LANE_OPS_PER_SM_CLOCK = 128
INT_OPS_PER_S = 132 * LANE_OPS_PER_SM_CLOCK * 1.98e9


def set_int_peak(torch):
    """INT_OPS_PER_S from the card: SMs x 128 x the maximum SM clock.
    Returns (SMs, MHz)."""
    global INT_OPS_PER_S
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    try:
        mhz = float(r.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no maximum SM clock: {r.stdout!r} "
             f"{r.stderr!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = sms * LANE_OPS_PER_SM_CLOCK * mhz * 1e6
    return sms, mhz
# Integer ops per reconstructed pixel: forward and inverse transform
# (2 passes of 8 adds + 2 shifts per 4 values: 5 each), quant (abs, mul,
# add, shift, sign: 5), dequant (2), prediction, residual, rounding and
# clip (5), the DC transforms and mode sums spread over the MB (2).
OPS_PER_PIXEL = 24
OPS_PER_I4_PIXEL = 6         # I_4x4 edge vectors and their 3-/2-tap filters


def commit_bound(args, kw, got):
    """Least time the card could take for one commit on these inputs: the
    larger of the bytes it must move and the integer ops these MBs need,
    over the memory and ALU rates. Bytes: each output written once, and
    of the inputs only what this frame's MBs read: an intra MB its 384
    source bytes, modes, QPs and I_4x4 flag (its 16 I_4x4 modes only if
    it is I_4x4), an inter MB its 384 bytes of inter reconstruction;
    plus the intra mask, quant tables and progress words.
    Returns (bound_ms, bound_by, bytes, ops)."""
    maps = args[3:7]                # i16, chroma modes, qp, qpc per MB
    n = args[7] * args[8]
    intra = kw.get("is_intra")
    n_intra = n if intra is None else int(intra.sum())
    i4 = kw.get("i4_mask")
    n_i4 = 0 if i4 is None else int((i4 if intra is None else i4 & intra)
                                    .sum())
    per_intra = 384 + sum(m.element_size() for m in maps)
    nbytes = n_intra * per_intra + (n - n_intra) * 384
    if i4 is not None:
        nbytes += (n_intra * i4.element_size()
                   + n_i4 * 16 * kw["i4_modes"].element_size())
    if intra is not None:
        nbytes += n * intra.element_size()
    nbytes += sum(t.numel() * t.element_size()
                  for t in list(got[0].values()) + list(got[1]))
    nbytes += 208 * 4 + (args[8] + 1) * 4          # quant tables, progress
    ops = OPS_PER_PIXEL * 384 * n_intra + OPS_PER_I4_PIXEL * 256 * n_i4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def real_p_commit(torch, C, variant, args, kw):
    """The frame kernel against commit_ref on a real P frame's commit
    arguments, then timed (CUDA events, 2 x 20 launches after 3), with its
    bound. Returns what the report reads."""
    ref, plain_ms = timed_ref(torch, C, args, kw)
    err = max_abs_err(ref, C.commit_cuda(*args, **kw))
    n_mb = args[7] * args[8]
    n_intra = int(kw["is_intra"].sum())
    n_i4 = int((kw["is_intra"] & kw["i4_mask"]).sum()) if "i4_mask" in kw \
        else 0
    log(f"phase 2 frame kernel vs commit_ref 1920x1088 {variant} on P frame "
        f"1: max_abs_err {err} (tolerance 0), intra MBs {n_intra} of "
        f"{n_mb}, I4 MBs {n_i4}")
    if err != 0:
        fail(f"frame kernel disagrees with commit_ref on a real P frame "
             f"({variant})")
    progs = []

    def run():
        progs.append(C.commit_launch(*args, **kw)[2])

    cuda_ms(torch, run, 3)                       # warm-up
    runs = [cuda_ms(torch, run, 20) for _ in range(2)]
    for prog in progs:
        C.check_progress(prog, args[7])
    bound_ms, bound_by, nbytes, ops = commit_bound(args, kw, ref)
    log(f"phase 2 {variant} commit per 1080p P frame (CUDA events, 20 runs "
        f"each): {runs[0]:.4f} / {runs[1]:.4f} ms; commit_ref "
        f"{plain_ms:.1f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} "
        f"({nbytes} bytes, {ops} integer ops)")
    return {"max_abs_err": err, "ms": sum(runs) / len(runs),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def background_core():
    """In a child before it runs: the lowest priority, on the last core."""
    os.nice(19)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def refdec_start(stream, tag="s", background=False):
    """Start tools/refdec.py on an Annex-B stream in a process of its own
    (the decoder reads x264_tpu's spec tables, and this process imports
    nothing of x264_tpu); with `background`, at the lowest priority on one
    core, so that it can run beside timed phases. Returns what
    refdec_finish takes."""
    work = os.path.join(ROOT, "x264_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, tag + ".264")
    raw = os.path.join(work, tag + ".yuv")
    with open(src, "wb") as f:
        f.write(stream)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "refdec.py"), src, raw],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT),
        preexec_fn=background_core if background else None)
    CHILDREN.append(proc)
    return proc, raw, time.time()


def refdec_finish(job, w, h, timeout=600):
    """Wait for a refdec_start job -> ([(y, u, v)] in coding order, the
    seconds it took)."""
    import numpy as np
    proc, raw, t0 = job
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"refdec did not finish within {timeout} s")
    if proc.returncode != 0:
        fail("refdec failed: " + err[-2000:])
    data = np.fromfile(raw, np.uint8)
    n = w * h * 3 // 2
    frames = []
    for k in range(len(data) // n):
        fr = data[k * n:(k + 1) * n]
        frames.append((fr[:w * h].reshape(h, w),
                       fr[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                       fr[w * h * 5 // 4:].reshape(h // 2, w // 2)))
    return frames, time.time() - t0


def same_frames(decoded, frames):
    """refdec's frames (coding order) equal `frames` ([y, u, v] each)."""
    import numpy as np
    return len(decoded) == len(frames) and all(
        np.array_equal(d[c], f[c])
        for d, f in zip(decoded, frames) for c in range(3))



def check_clean_imports():
    """Import every module of the port, then fail on jax or x264_tpu."""
    import importlib
    import pkgutil
    import x264_tpu_torch
    for m in pkgutil.walk_packages(x264_tpu_torch.__path__,
                                   "x264_tpu_torch."):
        importlib.import_module(m.name)
    bad = sorted(m for m in sys.modules if m == "jax"
                 or m.startswith(("jax.", "jaxlib")) or m == "x264_tpu"
                 or m.startswith("x264_tpu."))
    if bad:
        fail(f"modules of JAX or of the x264_tpu package were imported: "
             f"{bad[:10]}")


def kernel_stats(torch, C, args, kw, grid=None):
    """One launch with the kernel's cycle counters on: per MB, the mean
    time (us, at the SM clock the run itself shows) that a block waited
    at the start of an MB, and that its luma (I16, I_4x4) and chroma
    took; the waiter warp's polling; and the blocks' mean run time."""
    grid = grid or min(args[8], C.grid_capacity(args[0].device))
    stats = torch.zeros((grid, len(C.STATS_FIELDS)), dtype=torch.int64,
                        device=args[0].device)
    prog = C.commit_launch(*args, grid=grid, stats=stats, **kw)[2]
    C.check_progress(prog, args[7])
    tot = dict(zip(C.STATS_FIELDS, stats.sum(0).tolist()))
    ghz = tot["run_cycles"] / tot["run_ns"]
    mbs, i4 = tot["mbs"], tot["i4_mbs"]

    def us(cycles, n):
        return cycles / max(n, 1) / ghz / 1e3

    return {"sm_ghz": ghz, "block_run_us": tot["run_ns"] / grid / 1e3,
            "wait_us_per_mb": us(tot["wait_cycles"], mbs),
            "poll_us_per_mb": us(tot["poll_cycles"], mbs),
            "i16_luma_us": us(tot["i16_luma_cycles"], mbs - i4),
            "i4_luma_us": us(tot["i4_luma_cycles"], i4),
            "chroma_us": us(tot["chroma_cycles"], mbs)}


def latency_model(torch, C, dev, rng):
    """The frame kernel's time per MB on a frame one MB row tall (120 MBs
    in one block: an MB step t) and one MB column wide (68 rows, each
    waiting on the row above: t plus the hand-off h), all-I16 and
    all-I_4x4, random content and modes; each held against commit_ref
    first. CUDA events over 20 launches."""
    import numpy as np
    from x264_tpu_torch.ops.tables import chroma_qp
    out = {}
    for label, mbw, mbh in (("row", 120, 1), ("column", 1, 68)):
        H, W = 16 * mbh, 16 * mbw

        def rand(hi, shape, dtype=np.int32):
            return torch.from_numpy(rng.integers(0, hi, shape)
                                    .astype(dtype)).to(dev)

        planes = [rand(256, s, np.uint8)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
        qp = torch.full((mbh, mbw), 23, dtype=torch.int32, device=dev)
        qpc = torch.full_like(qp, int(chroma_qp(23)))
        args = (*planes, rand(4, (mbh, mbw)), rand(4, (mbh, mbw)), qp, qpc,
                mbw, mbh)
        modes = rand(9, (mbh, mbw, 16))
        for kind in ("i16", "i4"):
            kw = dict(i4_mask=torch.full((mbh, mbw), kind == "i4",
                                         dtype=torch.bool, device=dev),
                      i4_modes=modes)
            err = max_abs_err(C.commit_ref(*args, **kw),
                              C.commit_cuda(*args, **kw))
            if err != 0:
                fail(f"frame kernel disagrees with commit_ref ({label} "
                     f"{kind})")
            progs = []
            ms = cuda_ms(torch, lambda: progs.append(
                C.commit_launch(*args, **kw)[2]), 20)
            for prog in progs:
                C.check_progress(prog, mbw)
            out[f"{label}_{kind}_us_per_mb"] = ms * 1e3 / (mbw * mbh)
    for kind in ("i16", "i4"):
        out[f"handoff_{kind}_us"] = (out[f"column_{kind}_us_per_mb"]
                                     - out[f"row_{kind}_us_per_mb"])
    return out


# ------------------------------------------ the batched launch (phase 2)
def rand_frame(rng, w, h):
    """Random uint8 planes [y, u, v] of a w x h frame."""
    import numpy as np
    return [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def check_batch(torch, C, calls, label, against, refs=None):
    """One batched launch of the per-item `calls` (C.commit_batch) held
    item by item against `against`: "commit_ref" (or its outputs `refs`,
    computed already), or "single launches" of the frame kernel (verified
    against commit_ref above). Fails unless the batch was one launch and
    every item agrees. Returns the worst max_abs_err and the batch's
    outputs."""
    n0 = C.commit.launches
    got = C.commit_batch(calls)
    torch.cuda.synchronize()
    if C.commit.launches != n0 + 1:
        fail(f"the batch of {len(calls)} ({label}) made "
             f"{C.commit.launches - n0} launches, expected 1")
    fn = C.commit_ref if against == "commit_ref" else C.commit_cuda
    if refs is None:
        refs = [fn(*a, **k) for a, k in calls]
    errs = [max_abs_err(r, g) for r, g in zip(refs, got)]
    log(f"phase 2 batched frame kernel, B={len(calls)} {label}, vs "
        f"{against} item by item: max_abs_err {max(errs)} (tolerance 0), "
        f"global MB rows {len(calls) * calls[0][0][8]}")
    if max(errs) != 0:
        fail(f"the batched frame kernel disagrees with {against} ({label}, "
             f"B={len(calls)}, per item {errs})")
    return max(errs), got


def batch_bound(calls, outs):
    """commit_bound of a batch: the bytes and operations of its items
    summed. Returns (bound_ms, bound_by, bytes, ops)."""
    nbytes = ops = 0
    for (a, k), got in zip(calls, outs):
        _, _, b, o = commit_bound(a, k, got)
        nbytes, ops = nbytes + b, ops + o
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def batched_phase(torch, C, dev, rng, clip, enc_big, qp_i, cap):
    """Phase 2, the batched launch (a leading item axis: the frames of
    several streams, or the slice bands of a frame): B = 2 and 3 at 64x48
    and 48x32 in the four variants and a batch whose B * mbh exceeds the
    co-resident grid, against commit_ref item by item; B = 2 real 1080p
    frames in the four variants against single launches; the 1080p frame
    as 4 bands of 17 MB rows (the mesh's I step) against commit_ref, timed
    with its plain version and bound; S = 1, 2, 4 1080p frames in one
    launch against S single launches, timed in turns."""
    from x264_tpu_torch.encoder.encoder import Encoder
    worst = 0
    tall = cap // 2 + 3          # 2 items: 2 * tall > cap global rows
    for label, w, h, bs in (("64x48", 64, 48, (2, 3)),
                            ("48x32", 48, 32, (2, 3)),
                            (f"256x{16 * tall}", 256, 16 * tall, (2,))):
        enc = Encoder(intra_params(w, h), device=dev)
        for B in bs:
            for variant, mixed, with_i4 in VARIANTS:
                if w == 256 and variant in ("i16", "mixed"):
                    continue
                calls = [commit_inputs(torch, enc, enc._pad_to_mb(
                    rand_frame(rng, w, h)), qp_i, seed=20 + b, mixed=mixed,
                    with_i4=with_i4) for b in range(B)]
                worst = max(worst, check_batch(torch, C, calls,
                                               f"{label} {variant}",
                                               "commit_ref")[0])
    frames = [enc_big._pad_to_mb(f) for f in clip[:4]]
    for variant, mixed, with_i4 in VARIANTS:
        calls = [commit_inputs(torch, enc_big, f, qp_i, seed=30 + b,
                               mixed=mixed, with_i4=with_i4)
                 for b, f in enumerate(frames[:2])]
        worst = max(worst, check_batch(torch, C, calls,
                                       f"1920x1088 {variant}",
                                       "single launches")[0])
    # the mesh's I step on one 1080p frame: 4 bands of 17 MB rows, I16
    enc_band = Encoder(intra_params(1920, 272), device=dev)
    y, u, v = frames[0]
    band_calls = [commit_inputs(
        torch, enc_band, [y[272 * b:272 * (b + 1)], u[136 * b:136 * (b + 1)],
                          v[136 * b:136 * (b + 1)]], qp_i, seed=0,
        mixed=False, with_i4=False) for b in range(4)]
    refs = [timed_ref(torch, C, a, k) for a, k in band_calls]
    plain_ms = sum(ms for _, ms in refs)
    err, got = check_batch(torch, C, band_calls, "4 bands of 1920x272 i16",
                           "commit_ref", refs=[r for r, _ in refs])
    worst = max(worst, err)
    bargs, bkw = C.stack_calls(band_calls)
    progs = []

    def run_bands():
        progs.append(C.commit_launch(*bargs, **bkw)[2])

    cuda_ms(torch, run_bands, 3)                  # warm-up
    band_ms = [cuda_ms(torch, run_bands, 20) for _ in range(2)]
    bound_ms, bound_by, nbytes, ops = batch_bound(band_calls, got)
    log(f"phase 2 batched launch, 4 bands of 17 MB rows (1920x1088 in one "
        f"launch; CUDA events, 20 runs each): {band_ms[0]:.4f} / "
        f"{band_ms[1]:.4f} ms; commit_ref over the 4 bands {plain_ms:.1f} "
        f"ms; bound {bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} bytes, "
        f"{ops} integer ops)")
    # S frames in one launch against S single launches, I16+I4
    calls = [commit_inputs(torch, enc_big, f, qp_i, seed=0, mixed=False,
                           with_i4=True) for f in frames]
    timing = {}
    for S in (1, 2, 4):
        items = calls[:S]
        bargs, bkw = C.stack_calls(items)

        def batch():
            progs.append(C.commit_launch(*bargs, **bkw)[2])

        def singles():
            for a, k in items:
                progs.append(C.commit_launch(*a, **k)[2])

        for fn in (singles, batch):
            cuda_ms(torch, fn, 3)                 # warm-up
        s_ms = [cuda_ms(torch, singles, 20)]
        b_ms = [cuda_ms(torch, batch, 20), cuda_ms(torch, batch, 20)]
        s_ms.append(cuda_ms(torch, singles, 20))
        out, recon, prog = C.commit_launch(*bargs, **bkw)
        progs.append(prog)
        b_bound = batch_bound(items, [
            ({k: t[b] for k, t in out.items()}, [r[b] for r in recon])
            for b in range(S)])
        timing[S] = {"batched_ms": b_ms, "singles_ms": s_ms,
                     "bound_ms": b_bound[0], "bound_by": b_bound[1],
                     "bytes": b_bound[2]}
        log(f"phase 2 S={S} 1080p I16+I4 frames (CUDA events, 20 runs each; "
            f"singles, batch, batch, singles): one batched launch "
            f"{b_ms[0]:.4f} / {b_ms[1]:.4f} ms, {S} single launches "
            f"{s_ms[0]:.4f} / {s_ms[1]:.4f} ms; bound "
            f"{b_bound[0] * 1e3:.3f} us by {b_bound[1]} ({b_bound[2]} bytes)")
    for prog in progs:
        C.check_progress(prog, 120)
    return {"worst": worst, "band_ms": sum(band_ms) / 2,
            "band_plain_ms": plain_ms, "band_bound_ms": bound_ms,
            "band_bound_by": bound_by, "timing": timing}


# ------------------------------------------- the deblock kernel (phase 2)
# Integer ops of one filtered line (the three edge tests, the normal
# filter's delta, clips and p1 / q1 taps, or the strong filter's taps):
# counted only for lines whose strength is not 0, as this run's data needs
OPS_PER_LUMA_LINE = 60
OPS_PER_CHROMA_LINE = 30
# MB rows per block timed beside the kernel's own (deblock_launch_rows)
ROWS_TRIED = (1, 2, 4, 8)


def deblock_bound(args, kw):
    """Least time the card could take for one deblock on these inputs:
    the larger of the bytes it must move (the planes read and written
    once, both strength tensors and the QP map as int32, the progress
    words) over the memory rate, and the integer ops of the lines whose
    strength is not 0 (the picture's left and top edges have none) over
    the ALU rate. Returns (bound_ms, bound_by, bytes, ops)."""
    y, u, v, bs_v, bs_h, qp = args[:6]
    nbytes = (2 * sum(p.numel() for p in (y, u, v))
              + 4 * (bs_v.numel() + bs_h.numel() + qp.numel())
              + 4 * (kw["mbh"] + 1))
    bv, bh = bs_v.clone(), bs_h.clone()
    bv[:, 0, 0] = 0
    bh[0, :, 0] = 0
    luma = 4 * int((bv > 0).sum() + (bh > 0).sum())
    chroma = 4 * int((bv[:, :, 0::2] > 0).sum() + (bh[:, :, 0::2] > 0).sum())
    ops = OPS_PER_LUMA_LINE * luma + OPS_PER_CHROMA_LINE * chroma
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def planes_err(ref, got):
    """Largest |ref - got| over the planes of two (y, u, v)."""
    return max(int((r.int() - g.int()).abs().max()) for r, g in zip(ref, got))


def capture_calls(module, name, calls, limit=1):
    """Wrap module.<name> (a function the module looks up when it calls
    it): the first `limit` calls' (args, kwargs) are appended to `calls`,
    their tensors cloned, and every call goes through. Returns the
    function that puts the original back."""
    import torch
    real = getattr(module, name)

    def keep(*args, **kw):
        if len(calls) < limit:
            calls.append(([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], dict(kw)))
        return real(*args, **kw)

    setattr(module, name, keep)
    return lambda: setattr(module, name, real)


def blocky_frame(torch, w, h, seed, dev):
    """Planes with 16x16 and 4x4 steps and noise, so that the normal and
    the strong filter both fire."""
    import numpy as np
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (110 + 24 * ((xx // 16 + yy // 16) % 2)
         + 10 * ((xx // 4 + yy // 4) % 2) + r.integers(-3, 4, (h, w)))
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    u = (120 + 14 * ((cx // 8 + cy // 8) % 2)
         + r.integers(-3, 4, (h // 2, w // 2)))
    v = r.integers(100, 140, (h // 2, w // 2))
    return [torch.from_numpy(np.clip(p, 0, 255).astype(np.uint8)).to(dev)
            for p in (y, u, v)]


def deblock_phase(torch, D, dev, rng, i_frame, p_call, b_call):
    """Phase 2, the deblock kernel: deblock_cuda against deblock_ref on the
    card, tolerance 0 (every output is an integer), inputs left as they
    were: intra and random strengths with per-MB QPs over 0-51 (both ends
    present) and a_off / b_off / cqpo at -12 / 12 / -12, 0 and 12 / -12 /
    12 at 64x48, 48x32, 16x16, 16x64, 128x16, 16x80, 16x32 and 32x208
    (fewer MB rows than a band, part bands, whole bands; at offsets 0 also
    one block walking every band); at 1920x1088 the I frame's
    reconstruction (phase 2's commit) with intra strengths, with all
    blocks and with 7, random strengths, and the real calls that the
    encoder made: P frame 1 at preset medium (compute_strengths, two
    references) and the default path's first B frame
    (compute_strengths_b). Then the real P call and the I frame timed
    (CUDA events, 2 x 20 launches after 3, in turns) with the kernel, the
    first port's kernel (deblock_launch_rowwarp) and the kernel at each
    band height of ROWS_TRIED (deblock_launch_rows; each output equal to
    deblock_ref's), beside deblock_ref (one run) and their bounds.
    Returns what the report reads."""
    import numpy as np
    worst = 0

    def check(label, args, kw, grids=(None,)):
        nonlocal worst
        before = [a.clone() for a in args[:6]]
        box = []
        ref_ms = cuda_ms(torch, lambda: box.append(D.deblock_ref(*args,
                                                                 **kw)), 1)
        changed = sum(int((r != a).sum()) for r, a in zip(box[0], args[:3]))
        for grid in grids:
            got = D.deblock_cuda(*args, grid=grid, **kw)
            err = planes_err(box[0], got)
            kept = all(torch.equal(b, a) for b, a in zip(before, args))
            log(f"phase 2 deblock kernel vs deblock_ref {label}"
                f"{'' if grid is None else f', {grid} block(s)'}: "
                f"max_abs_err {err} (tolerance 0), pixels changed by the "
                f"filter {changed}, inputs unchanged {kept}")
            if err != 0 or not kept:
                fail(f"deblock kernel disagrees with deblock_ref or wrote "
                     f"its inputs ({label}, grid {grid})")
            worst = max(worst, err)
        return ref_ms, box[0]

    for w, h in ((64, 48), (48, 32), (16, 16), (16, 64), (128, 16),
                 (16, 80), (16, 32), (32, 208)):
        mbw, mbh = w // 16, h // 16
        for kind in ("intra", "random"):
            for off in (-12, 0, 12):
                planes = blocky_frame(torch, w, h, int(rng.integers(1 << 30)),
                                      dev)
                if kind == "intra":
                    bs = D.intra_strengths(mbw, mbh, dev)
                else:
                    bs = [torch.from_numpy(rng.integers(
                        0, 5, (mbh, mbw, 4, 4)).astype(np.int32)).to(dev)
                        for _ in range(2)]
                qp = rng.integers(0, 52, (mbh, mbw)).astype(np.int32)
                qp.flat[0], qp.flat[-1] = 0, 51
                kw = dict(mbw=mbw, mbh=mbh, a_off=off, b_off=-off,
                          chroma_qp_offset=off)
                check(f"{w}x{h} {kind} strengths, QP 0-51, offsets "
                      f"{off}/{-off}/{off}",
                      [*planes, *bs, torch.from_numpy(qp).to(dev)], kw,
                      grids=(None, 1) if off == 0 else (None,))

    c_args, c_kw, c_ref, _ = i_frame
    mbw, mbh = c_args[7], c_args[8]
    i_args = [p.contiguous() for p in c_ref[1]] + [
        *D.intra_strengths(mbw, mbh, dev), c_args[5]]
    i_kw = dict(mbw=mbw, mbh=mbh)
    size = f"{16 * mbw}x{16 * mbh}"
    i_plain, i_ref = check(f"{size} I frame (phase 2's commit), intra "
                           f"strengths", i_args, i_kw,
                           grids=(None, min(7, -(-mbh // D.band_rows()))))
    qp = torch.from_numpy(rng.integers(0, 52, (mbh, mbw)).astype(np.int32))
    check(f"{size} random strengths, QP 0-51, offsets 12/-12/12",
          [*blocky_frame(torch, 16 * mbw, 16 * mbh, 3, dev),
           *[torch.from_numpy(rng.integers(0, 5, (mbh, mbw, 4, 4))
                              .astype(np.int32)).to(dev) for _ in range(2)],
           qp.to(dev)],
          dict(mbw=mbw, mbh=mbh, a_off=12, b_off=-12, chroma_qp_offset=12))
    p_args, p_kw = p_call
    p_plain, p_ref = check(f"{size} P frame 1 at preset medium "
                           f"(compute_strengths, two references)", p_args,
                           p_kw)
    b_args, b_kw = b_call
    check(f"{size} B frame of the default path (compute_strengths_b)",
          b_args, b_kw)

    rows = D.band_rows()
    out = {"worst": worst, "capacity": D.grid_capacity(dev), "rows": rows,
           "chain_steps": mbw + mbh - 1,
           "earlier_chain_steps": mbw + 2 * (mbh - 1)}
    kernels = {"kernel": (D.deblock_launch, {}, False),
               "rowwarp": (D.deblock_launch_rowwarp, {}, True),
               **{f"rows {r}": (D.deblock_launch_rows, {"rows": r}, False)
                  for r in ROWS_TRIED}}
    for key, args, kw, plain, ref in (("p", p_args, p_kw, p_plain, p_ref),
                                      ("i", i_args, i_kw, i_plain, i_ref)):
        runs, progs = {name: [] for name in kernels}, []
        for name, (fn, extra, rowwarp) in kernels.items():
            got = fn(*args, **kw, **extra)
            D.check_launch(got[1], kw["mbw"], rowwarp)
            err = planes_err(ref, got[0])
            if err != 0:
                fail(f"deblock {name} on the {size} {key.upper()} frame: "
                     f"max_abs_err {err} against deblock_ref")

            def run(fn=fn, extra=extra, rowwarp=rowwarp):
                progs.append((fn(*args, **kw, **extra)[1], rowwarp))

            cuda_ms(torch, run, 3)                   # warm-up
        for turn in range(2):                       # in turns, then back
            for name in (list(kernels) if turn == 0 else
                         list(reversed(kernels))):
                fn, extra, rowwarp = kernels[name]
                runs[name].append(cuda_ms(
                    torch, lambda: progs.append((fn(*args, **kw, **extra)[1],
                                                 rowwarp)), 20))
        for prog, rowwarp in progs:
            D.check_launch(prog, kw["mbw"], rowwarp)
        bound_ms, bound_by, nbytes, ops = deblock_bound(args, kw)
        ms = {name: sum(r) / len(r) for name, r in runs.items()}
        out[key] = {"ms": ms["kernel"], "runs": runs["kernel"],
                    "earlier_ms": ms["rowwarp"],
                    "earlier_runs": runs["rowwarp"],
                    "rows_ms": {r: ms[f"rows {r}"] for r in ROWS_TRIED},
                    "plain_ms": plain, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                    "us_per_chain_step": ms["kernel"] * 1e3
                    / out["chain_steps"],
                    "earlier_us_per_chain_step": ms["rowwarp"] * 1e3
                    / out["earlier_chain_steps"]}
        o = out[key]
        log(f"phase 2 deblock kernel per {size} {key.upper()} frame (CUDA "
            f"events, 20 runs each, in turns): {rows} MB rows per block "
            f"{runs['kernel'][0]:.4f} / {runs['kernel'][1]:.4f} ms, "
            f"{out['chain_steps']} MB steps in the chain: "
            f"{o['us_per_chain_step']:.3f} us each; the first port's "
            f"kernel {runs['rowwarp'][0]:.4f} / {runs['rowwarp'][1]:.4f} ms, "
            f"{out['earlier_chain_steps']} steps: "
            f"{o['earlier_us_per_chain_step']:.3f} us each; MB rows per "
            f"block " + ", ".join(
                f"{r}: {runs[f'rows {r}'][0]:.4f} / "
                f"{runs[f'rows {r}'][1]:.4f} ms" for r in ROWS_TRIED)
            + f"; deblock_ref {plain:.1f} ms (1 run); bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} bytes, {ops} "
            f"integer ops)")
        if o["ms"] >= o["earlier_ms"]:
            fail(f"the deblock kernel ({o['ms']:.4f} ms) is not faster than "
                 f"the first port's ({o['earlier_ms']:.4f} ms) on the "
                 f"{size} {key.upper()} frame")
    return out


# -------------------------------------- the motion kernels (phase 2)
# The least instructions the searches need on this card: a packed byte
# SAD (__vsadu4: VABSDIFF4 with its accumulate) for four absolute
# differences and their sum (the half-res scan's int32 values are bytes
# too); per MB and offset, the lanes' sums and the MV rate (the 16x16 lane
# alone, or every partition lane); per 4x4 block and qpel candidate, 16
# dp4a (the rows' Hadamard, one per pixel, accumulated onto the source's),
# 16 column butterflies, 16 absolute values, 8 maxima and 8 adds, and one
# per row where two half-pel planes are averaged; per lane and candidate,
# a multiply-add per weighed block and the MV rate and key.
PIXELS_PER_SAD_OP = 4
OPS_PER_OFFSET = {1: 6, 9: 16}
OPS_PER_SATD_BLOCK = 64
OPS_PER_AVG_ROW = 1
OPS_PER_LANE_CAND = 14


def subpel_pairs(lane_mv, masks):
    """The (lane, 4x4 block) pairs of a qpel refine over all MBs: those
    its masks weigh, and those me_subpel_kernel computes (a weighed pair
    whose SATDs no earlier lane with the same full-pel MV computes: the
    first lane with that MV that weighs the block). lane_mv [L, mbh, mbw,
    2], masks [L, 16]. Returns (weighed, computed), each a count."""
    import torch
    L = lane_mv.shape[0]
    mv = lane_mv.reshape(L, -1, 2)
    w = masks != 0                                      # [L, 16]
    same = (mv[:, None] == mv[None]).all(-1)            # [j, l, n]
    order = torch.arange(L, device=mv.device)
    before = (order[:, None] < order[None, :])[:, :, None]
    # [j, l, n, 16]: lane j, before lane l and with its MV, weighs the block
    shared = (same & before)[..., None] & w[:, None, None, :]
    weighed = int(w.sum()) * mv.shape[1]
    return weighed, weighed - int((shared.any(0) & w[:, None, :]).sum())


def motion_bound(name, args, out):
    """Least time the card could take for one launch of motion kernel
    `name` with the wrapper's arguments `args` and its outputs `out`: the
    larger of the bytes it must move (each input tensor read once, each
    output written once) over the memory rate, and the instructions of
    this launch's candidates over the issue rate; the qpel refine counts
    only the 4x4 blocks that need computing (subpel_pairs), as it computes
    only those. Returns (bound_ms, bound_by, bytes, ops)."""
    import torch
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    outs = list(out.values()) if isinstance(out, dict) else (
        list(out) if isinstance(out, tuple) else [out])
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    if name == "me_lowres_scan":
        lsrc, _, rl = args[:3]
        n, k = lsrc.numel() // 64, (2 * rl + 1) ** 2
        ops = n * k * (64 // PIXELS_PER_SAD_OP + OPS_PER_OFFSET[1])
    elif name in ("me_refine", "me_esa"):
        y, radius, shapes = args[1], args[-3], args[-2]
        n, k = y.numel() // 256, (2 * radius + 1) ** 2
        ops = n * k * (256 // PIXELS_PER_SAD_OP
                       + OPS_PER_OFFSET[9 if shapes else 1])
    else:
        lane_mv, masks, tab = args[2], args[3], args[4]
        n, cands = args[1].numel() // 256, tab.shape[0]
        _, pairs = subpel_pairs(lane_mv, masks)
        ops = pairs * (cands * OPS_PER_SATD_BLOCK
                       + 4 * OPS_PER_AVG_ROW * int((tab[:, 8] != 0).sum()))
        ops += n * cands * (int((masks != 0).sum())
                            + masks.shape[0] * OPS_PER_LANE_CAND)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def ptxas_report(build_log):
    """Each kernel's ptxas report in the library's build.log, by mangled
    name: registers, static shared memory, stack frame and spill bytes."""
    import re
    out, name = {}, None
    with open(build_log) as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
                out[name] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and name:
                out[name].update(stack_bytes=int(m[1]),
                                 spill_bytes=int(m[2]) + int(m[3]))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
            if m and name:
                out[name].update(registers=int(m[1]), smem_bytes=int(m[2]))
    return out


def motion_ptxas(ptxas, name, args=None):
    """The ptxas report of motion kernel `name` (a MOTION_KERNELS name);
    the full-pel kernels' instantiation is the one these wrapper
    arguments launch (9 lanes where they ask for shapes)."""
    part = {"me_lowres_scan": "me_lowres_scan_kernel",
            "me_subpel": "me_subpel_kernel"}.get(name)
    if part is None:
        lanes = 9 if args[-2] else 1
        part = (f"me_fullpel_kernelILi{96 if name == 'me_refine' else 256}"
                f"ELi{lanes}E")
    hits = [v for k, v in ptxas.items() if part in k]
    if len(hits) != 1:
        fail(f"build.log: {len(hits)} ptxas reports match {part}")
    return hits[0]


def sass_loop(lib, kernel, opcode="VABSDIFF4"):
    """The innermost loop of `kernel` (part of its mangled name) in the
    library's SASS (cuobjdump -sass) that holds `opcode`: (its
    instructions, how many are `opcode`, their opcodes counted), or the
    reason it could not be read."""
    import collections
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return "cuobjdump not found"
    r = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    bodies = [sec for sec in r.stdout.split("Function : ")[1:]
              if kernel in sec.split("\n", 1)[0]]
    if len(bodies) != 1:
        return f"{len(bodies)} SASS functions match {kernel}"
    ins = []                                    # (address, opcode, text)
    for line in bodies[0].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            ins.append((int(m[1], 16), m[2], m[3]))
    loops = []
    for at, op, rest in ins:
        to = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") \
            else None
        if to and int(to[1], 16) < at:
            body = [i for i in ins if int(to[1], 16) <= i[0] <= at]
            hits = sum(i[1].startswith(opcode) for i in body)
            if hits:
                loops.append((len(body), hits, body))
    if not loops:
        return f"no loop of {kernel} holds {opcode}"
    size, hits, body = min(loops, key=lambda x: x[0])
    return size, hits, dict(collections.Counter(
        i[1].split(".")[0] for i in body).most_common())


def nested_err(ref, got):
    """Largest |ref - got| over two equal structures of tensors (dicts,
    tuples, lists)."""
    if isinstance(ref, dict):
        if set(ref) != set(got):
            return float("inf")
        return max(nested_err(ref[k], got[k]) for k in ref)
    if isinstance(ref, (tuple, list)):
        return max(nested_err(a, b) for a, b in zip(ref, got))
    if ref.shape != got.shape:
        return float("inf")
    return int((ref.long() - got.long()).abs().max())


def motion_parts(kind, args, kw):
    """The motion kernels' launches inside one call of a public search
    (`kind`: "seeded", "esa", "subpel_all", "subpel_mc") with these
    arguments: [(kernel, launch, plain version, arguments of both)], each
    launch's inputs computed as the search computes them, from the plain
    stages before it. Returns (those, the public search, its *_ref)."""
    import torch
    from x264_tpu_torch.device import const
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.ops import mc
    from x264_tpu_torch.ops import motion as MO
    if kind == "seeded":
        yp, y, lam, R = args[:4]
        shapes, cap = kw.get("shapes", False), kw.get("pir_cap")
        M = kw.get("refine", 4)
        H, W = y.shape
        rl = (R + 1) // 2
        lsrc = inter._lowres(y)
        lref = mc._clamped(inter._lowres(yp[mc.PAD:mc.PAD + H,
                                            mc.PAD:mc.PAD + W]),
                           rl + 1, rl + 1, rl + 1, rl + 1)
        low = (lsrc, lref, rl, lam)
        seed = (2 * MO.lowres_scan_plain(*low)).clamp(-(R - M), R - M)
        mvp = inter.mv_predictors(seed * 4)[0].contiguous()
        ref = (yp, y, seed, mvp, lam, M, shapes, cap)
        return ([("me_lowres_scan", MO.lowres_scan_launch,
                  MO.lowres_scan_plain, low),
                 ("me_refine", MO.refine_launch, MO.fullpel_plain, ref)],
                inter.motion_search_seeded, inter.motion_search_seeded_ref)
    if kind == "esa":
        yp, _, y, lam, R = args[:5]
        shapes = args[5] if len(args) > 5 else kw.get("shapes", False)
        cap = kw.get("pir_cap")

        def plain(yp, y, mvp, lam, R, shapes, cap):
            return MO.fullpel_plain(yp, y, None, mvp, lam, R, shapes, cap)

        mv1 = plain(yp, y, None, lam, R, False, cap)
        mvp = inter.mv_predictors(mv1 * 4)[0].contiguous()
        return ([("me_esa", MO.esa_launch, plain,
                  (yp, y, None, lam, R, False, cap)),
                 ("me_esa", MO.esa_launch, plain,
                  (yp, y, mvp, lam, R, shapes, cap))],
                inter.motion_search, inter.motion_search_ref)
    hp, y, mv, lam = args[:4]
    mvp_q = kw.get("mvp_q")
    if kind == "subpel_all":
        lanes = [mv["16x16"], *mv["16x8"].unbind(2), *mv["8x16"].unbind(2)]
        if kw.get("p8x8", True):
            lanes += list(mv["8x8"].unbind(2))
        lane_mv = torch.stack(lanes)
        public, ref = inter.subpel_refine_all, inter.subpel_refine_all_ref
    else:
        lane_mv = mv[None].contiguous()
        public, ref = inter.subpel_refine_mc, inter.subpel_refine_mc_ref
    dev = y.device
    sub = (hp, y, lane_mv, const(inter._PART_MASKS[:lane_mv.shape[0]], dev),
           const(inter._subpel_cand_table(3), dev), lam, mvp_q)
    return [("me_subpel", MO.subpel_launch, MO.subpel_plain, sub)], \
        public, ref


def motion_cases(torch, dev):
    """The tie inputs of tests/test_torch_motion.py on the card: 48x32
    luma planes (current, padded reference, its half-pel planes) that are
    flat, periodic (period 4, so SADs tie at offsets 4 apart) or moving,
    at lam 0, 6 and 200, me_range 4, 16 and 24, with and without the PIR
    cap. Yields (label, y, y_pad, hpel, lam, me_range, cap)."""
    import numpy as np
    from x264_tpu_torch.ops import mc
    w, h = 48, 32
    yy, xx = np.mgrid[0:h, 0:w]
    tex = ((xx % 4) * 40 + (yy % 4) * 25 + 20).astype(np.uint8)
    noise = np.random.default_rng(11).integers(0, 2, (h, w))
    mov = moving_frames(2, w, h, seed=11)
    content = {"flat": (np.full((h, w), 90, np.uint8),
                        np.full((h, w), 93, np.uint8)),
               "periodic": ((tex + noise).astype(np.uint8),
                            np.roll(tex, (1, 2), (0, 1))),
               "moving": (mov[1][0], mov[0][0])}
    cap = torch.tensor([[-4, 1, 1 << 20]] * 2, dtype=torch.int32,
                       device=dev)
    for label, kind, lam, R, pir in (
            ("flat", "flat", 6, 16, False),
            ("periodic, lam 0, me_range 4", "periodic", 0, 4, False),
            ("periodic, lam 200", "periodic", 200, 16, False),
            ("periodic, PIR cap", "periodic", 6, 16, True),
            ("moving, me_range 24", "moving", 6, 24, False)):
        y, r = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in content[kind])
        y_pad = mc.pad_plane(r)
        yield (f"48x32 {label}", y, y_pad, mc.hpel_planes(y_pad), lam, R,
               cap if pir else None)


def motion_phase(torch, dev, clip, b_calls):
    """Phase 2, the motion kernels: each against its plain version on the
    card (lowres_scan_plain, fullpel_plain, subpel_plain: the kernels'
    order), and each public search through its kernels against its
    sequential plain version (*_ref), tolerance 0 (every output is an
    integer): the tie cases of motion_cases (every search, 1, 5 and 9 qpel
    lanes); the real calls of P frame 2 of the 1080p clip at preset medium
    (the seeded search and the 9-lane refine against both references, as
    the encoder's dispatch made them) and of the default path's first B
    frame (the ESA and the 1-lane refine of both lists, `b_calls`); the
    ESA at me_range 24 with every lane (tesa's range) on P frame 2. The
    branches of the kernels' mapping (tests/motion_branches.py, the inputs
    tests/test_torch_motion.py holds against x264_tpu):
    subpel_lane_cases (lane MVs equal, copied and distinct, windows past
    each edge; 1, 5 and 9 lanes; the partition masks and random weights
    0-3) and refine_edge_cases. Then each kernel timed on its real 1080p
    inputs (CUDA events, 2 x 20 launches after 3, queued behind a
    torch.cuda._sleep so that the card's time is read; the B frame's
    second ESA pass for me_esa, P frame 2's first reference for the
    others) beside its plain version (one run) and its bound, and
    me_subpel at 9, 5 and 1 of that reference's lanes. Returns what the
    report reads."""
    import numpy as np
    from x264_tpu_torch.device import const
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.encoder.encoder import TYPE_IDR, TYPE_P, Encoder
    from x264_tpu_torch.ops import motion as MO
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from motion_branches import refine_edge_cases, subpel_lane_cases
    worst = {name: 0 for name, _, _ in MOTION_KERNELS}
    whole = {}
    timed = {}

    def check(label, kind, args, kw, time_as=None):
        parts, public, ref = motion_parts(kind, args, kw)
        for name, launch, plain, a in parts:
            want = plain(*a)
            got = launch(*a)
            err = nested_err(want, got)
            worst[name] = max(worst[name], err)
            if err != 0:
                fail(f"phase 2 {name} disagrees with its plain version "
                     f"({label}): max_abs_err {err}")
            if time_as is not None and name in time_as \
                    and name not in timed:
                timed[name] = (label, launch, plain, a, got)
        want, got = ref(*args, **kw), public(*args, **kw)
        err = nested_err(want, got)
        whole[kind] = max(whole.get(kind, 0), err)
        if err != 0:
            fail(f"phase 2 {kind} search through the kernels disagrees with "
                 f"its *_ref ({label}): max_abs_err {err}")
        return got

    n_small = 0
    for label, y, yp, hp, lam, R, cap in motion_cases(torch, dev):
        mvs = check(label, "esa", (yp, None, y, lam, R, True),
                    {"pir_cap": cap})
        check(label, "esa", (yp, None, y, lam, R, False), {"pir_cap": cap})
        check(label, "seeded", (yp, y, lam, R),
              {"shapes": True, "pir_cap": cap})
        mvp = inter.mv_predictors(mvs["16x16"] * 4)[0].reshape(-1, 2)
        for p8 in (False, True):
            check(label, "subpel_all", (hp, y, mvs, lam, R),
                  {"mvp_q": mvp.contiguous(), "p8x8": p8})
        check(label, "subpel_mc", (hp, y, mvs["16x16"], lam, R), {})
        n_small += 1
    torch.cuda.synchronize()
    log(f"phase 2 motion kernels vs their plain versions, {n_small} tie "
        f"cases at 48x32: max_abs_err {worst} (tolerance 0); searches vs "
        f"*_ref {whole}")

    def against_plain(name, label, want, got):
        err = nested_err(want, got)
        worst[name] = max(worst[name], err)
        if err != 0:
            fail(f"phase 2 {name} disagrees with its plain version "
                 f"({label}): max_abs_err {err}")

    tab = const(inter._subpel_cand_table(3), dev)
    rng = np.random.default_rng(4)
    n_branch = 0
    mov = moving_frames(2, 48, 32, seed=11)
    pair = (mov[1][0], mov[0][0], dev)
    for label, y, hp, mv, mvp, lam in subpel_lane_cases(*pair):
        lanes = mv.shape[0]
        for masks in (inter._PART_MASKS[:lanes],
                      rng.integers(0, 4, (lanes, 16)).astype(np.int32)):
            a = (hp, y, mv, const(masks, dev), tab, lam, mvp)
            want = MO.subpel_plain(*a)
            against_plain("me_subpel", label, want, MO.subpel_launch(*a))
            n_branch += 1
        if lanes == 1:
            check(label, "subpel_mc", (hp, y, mv[0], lam, 4), {})
        else:
            mvs = {"16x16": mv[0], "16x8": torch.stack([mv[1], mv[2]], 2),
                   "8x16": torch.stack([mv[3], mv[4]], 2),
                   "8x8": torch.stack(list(mv[5:]) if lanes == 9
                                      else [mv[0]] * 4, 2)}
            check(label, "subpel_all", (hp, y, mvs, lam, 4),
                  {"mvp_q": mvp, "p8x8": lanes == 9})
    for label, launch, plain, a in refine_edge_cases(*pair):
        against_plain("me_refine" if launch is MO.refine_launch
                      else "me_esa", label, plain(*a), launch(*a))
        n_branch += 1
    torch.cuda.synchronize()
    log(f"phase 2 the kernels' branch cases at 48x32 ({n_branch} launches "
        f"each: qpel lanes equal, copied and distinct, windows past each "
        f"edge, 1, 5 and 9 lanes, partition masks and random weights; "
        f"full-pel windows past each edge): max_abs_err {worst} (tolerance "
        f"0); searches vs *_ref {whole}")

    # P frame 2 of the 1080p clip at preset medium: its searches' calls
    h, w = clip[0][0].shape
    enc = Encoder(ippp_params(w, h), device=dev)
    enqueue(enc, clip[0], TYPE_IDR, 0)
    enqueue(enc, clip[1], TYPE_P, 1)
    seeded_calls, subpel_calls = [], []
    restore = [capture_calls(inter, "motion_search_seeded", seeded_calls, 2),
               capture_calls(inter, "subpel_refine_all", subpel_calls, 2)]
    enqueue(enc, clip[2], TYPE_P, 2)
    for r in restore:
        r()
    del enc
    if len(seeded_calls) != 2 or len(subpel_calls) != 2:
        fail(f"P frame 2 made {len(seeded_calls)} seeded searches and "
             f"{len(subpel_calls)} qpel refines, expected 2 each")
    for k, ((sa, skw), (qa, qkw)) in enumerate(zip(seeded_calls,
                                                   subpel_calls)):
        label = f"1080p P frame 2, reference {k}"
        check(label, "seeded", sa, skw,
              time_as=("me_lowres_scan", "me_refine"))
        check(label, "subpel_all", qa, qkw, time_as=("me_subpel",))
    yp, y = seeded_calls[0][0][:2]
    check("1080p P frame 2, reference 0, ESA at me_range 24, every lane",
          "esa", (yp, None, y, seeded_calls[0][0][2], 24, True), {})
    esa_calls, mc_calls = b_calls
    for k, ((ea, ekw), (ma, mkw)) in enumerate(zip(esa_calls, mc_calls)):
        label = f"1080p B frame of the default path, list {k}"
        check(label, "esa", ea, ekw)
        check(label, "subpel_mc", ma, mkw)
    # the B frame's second ESA pass is the me_esa launch that is timed
    ea, ekw = esa_calls[0]
    parts, _, _ = motion_parts("esa", ea, ekw)
    timed["me_esa"] = ("1080p B frame of the default path, list 0, pass 2",
                       *parts[1][1:], parts[1][1](*parts[1][3]))
    torch.cuda.synchronize()
    log(f"phase 2 motion kernels vs their plain versions, 1080p P frame 2 "
        f"(2 references), its ESA at me_range 24 and the B frame's 2 lists: "
        f"max_abs_err {worst} (tolerance 0); searches vs *_ref {whole}")
    pairs = [subpel_pairs(*motion_parts("subpel_all", qa, qkw)[0][0][3][2:4])
             for qa, qkw in subpel_calls]
    reused = sum(w - c for w, c in pairs) / sum(w for w, _ in pairs)
    log(f"phase 2 me_subpel on 1080p P frame 2: of the weighed (lane, 4x4 "
        f"block) pairs, {reused:.4f} read the SATDs of an earlier lane with "
        f"the same full-pel MV (references 0 / 1: (weighed, computed) "
        f"{pairs})")

    out = {"worst": worst, "whole": whole, "pairs_reused": reused,
           "pairs": pairs}
    for name, (label, launch, plain, a, got) in timed.items():
        plain_ms = cuda_ms(torch, lambda: plain(*a), 1)
        cuda_ms(torch, lambda: launch(*a), 3)            # warm-up
        runs = [cuda_ms(torch, lambda: launch(*a), 20, prefill=True)
                for _ in range(2)]
        bound_ms, bound_by, nbytes, ops = motion_bound(name, a, got)
        ms = sum(runs) / len(runs)
        out[name] = {"ms": ms, "runs": runs, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": ops, "shape": label, "args": a}
        log(f"phase 2 {name} on {label} (CUDA events, 20 launches each): "
            f"{runs[0]:.4f} / {runs[1]:.4f} ms; plain version {plain_ms:.1f} "
            f"ms (1 run); bound {bound_ms * 1e3:.3f} us by {bound_by} "
            f"({nbytes} bytes, {ops} instructions), "
            f"{bound_ms / ms:.4f} of it")
    # me_subpel on the first L lanes of P frame 2's reference 0
    label, _, _, a, _ = timed["me_subpel"]
    out["lanes"] = {}
    for lanes in (9, 5, 1):
        la = (a[0], a[1], a[2][:lanes].contiguous(),
              a[3][:lanes].contiguous(), *a[4:])
        want = MO.subpel_plain(*la)
        against_plain("me_subpel", f"{label}, {lanes} lanes", want,
                      MO.subpel_launch(*la))
        cuda_ms(torch, lambda: MO.subpel_launch(*la), 3)
        ms = [cuda_ms(torch, lambda: MO.subpel_launch(*la), 20,
                      prefill=True) for _ in range(2)]
        bound_ms = motion_bound("me_subpel", la, want)[0]
        out["lanes"][lanes] = {"ms": ms, "bound_ms": bound_ms}
        log(f"phase 2 me_subpel at {lanes} lanes of {label} (CUDA events, "
            f"20 launches each): {ms[0]:.4f} / {ms[1]:.4f} ms; bound "
            f"{bound_ms * 1e3:.3f} us")
    return out


def cavlc_bound(args, out):
    """Least time the card could take for one launch of the CAVLC kernel
    with the wrapper's arguments `args` and its outputs `out`: bytes, each
    input read once and each output written once (B x (4L + 4) in, B x
    (36 x 12 + 5) out), over the memory rate. Returns (bound_ms, bound_by,
    bytes)."""
    import torch
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in ins + list(out))
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def cavlc_phase(torch, dev, clip, ptxas):
    """Phase 2, the CAVLC residual coder kernel (csrc/cavlc.cu): against
    its plain version (entropy/cavlc_dev.py residual_blocks_plain) on the
    card, tolerance 0 in all four outputs, on every case of
    tests/cavlc_cases.py (each nC class, L = 16, 15 and the 2x2 / 2x4
    chroma DC, zero and full blocks, trailing ones, the suffix length's
    steps, the escape limit, a 1080p luma batch) and on the five calls of
    the device CAVLC writer of a real 1080p P frame at preset ultrafast
    (frame 1 of the clip; luma 16 and DC, luma AC 15, chroma DC, chroma
    AC). Then each of those calls timed (CUDA events, 2 x 20 launches after
    3, queued behind a torch.cuda._sleep) beside the plain version (one
    run) and its byte bound, and the kernel's ptxas report. Returns what
    the report reads."""
    from x264_tpu_torch.encoder.encoder import TYPE_IDR, TYPE_P, Encoder
    from x264_tpu_torch.entropy import cavlc_dev
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from cavlc_cases import cavlc_cases
    launch = cavlc_launch()
    worst = 0

    def against_plain(label, args):
        nonlocal worst
        want = cavlc_dev.residual_blocks_plain(*args)
        n0 = launch.launches
        got = cavlc_dev.residual_blocks_dev(*args)
        if launch.launches != n0 + 1:
            fail(f"phase 2 cavlc ({label}): {launch.launches - n0} launches "
                 f"for one call")
        for i, (w, g) in enumerate(zip(want, got)):
            if w.dtype != g.dtype or w.shape != g.shape:
                fail(f"phase 2 cavlc ({label}) output {i}: {g.dtype} "
                     f"{tuple(g.shape)}, expected {w.dtype} "
                     f"{tuple(w.shape)}")
            err = (w.long() - g.long()).abs().max().item() if w.numel() \
                else 0
            worst = max(worst, err)
            if err != 0:
                fail(f"phase 2 cavlc_residual_kernel disagrees with its "
                     f"plain version ({label}) in output {i}: max_abs_err "
                     f"{err}")
        return got

    cases = cavlc_cases(big=True)
    for name, (coeffs, nc, chroma_dc) in cases.items():
        against_plain(name, (torch.from_numpy(coeffs).to(dev),
                             torch.from_numpy(nc).to(dev), chroma_dc))
    torch.cuda.synchronize()
    log(f"phase 2 cavlc_residual_kernel vs residual_blocks_plain on "
        f"{len(cases)} cases ({sorted(cases)}): max_abs_err {worst} "
        f"(tolerance 0)")

    h, w = clip[0][0].shape
    enc = Encoder(ultrafast_params(w, h), device=dev)
    enqueue(enc, clip[0], TYPE_IDR, 0)
    calls = []
    restore = capture_calls(cavlc_dev, "residual_blocks_dev", calls, 5)
    enqueue(enc, clip[1], TYPE_P, 1)
    restore()
    del enc
    if len(calls) != 5:
        fail(f"phase 2: the 1080p ultrafast P frame made {len(calls)} "
             f"residual_blocks_dev calls, expected 5")
    out = {"cases": sorted(cases), "calls": []}
    for k, (a, kw) in enumerate(calls):
        coeffs = a[0].contiguous()
        chroma_dc = kw.get("chroma_dc", a[2] if len(a) > 2 else False)
        nc = None if chroma_dc else a[1].contiguous()
        label = (f"1080p ultrafast P frame 1, call {k}: "
                 f"{'chroma DC' if chroma_dc else 'nC'} B = "
                 f"{coeffs.shape[0]}, L = {coeffs.shape[1]}")
        args = (coeffs, a[1], chroma_dc)
        got = against_plain(label, args)
        plain_ms = cuda_ms(torch, lambda: cavlc_dev.residual_blocks_plain(
            *args), 1)
        largs = (coeffs, nc, chroma_dc)
        cuda_ms(torch, lambda: launch(*largs), 3)         # warm-up
        runs = [cuda_ms(torch, lambda: launch(*largs), 20, prefill=True)
                for _ in range(2)]
        ms = sum(runs) / 2
        bound_ms, bound_by, nbytes = cavlc_bound(largs, got)
        out["calls"].append({"label": label, "B": coeffs.shape[0],
                             "L": coeffs.shape[1], "chroma_dc": chroma_dc,
                             "ms": ms, "runs": runs, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "bytes": nbytes, "bound_share": bound_ms / ms})
        log(f"phase 2 cavlc_residual_kernel on {label} (CUDA events, 20 "
            f"launches each): {runs[0]:.4f} / {runs[1]:.4f} ms; plain "
            f"version {plain_ms:.2f} ms (1 run); bound {bound_ms * 1e3:.3f} "
            f"us by {bound_by} ({nbytes} bytes), {bound_ms / ms:.4f} of it")
    hits = [v for k, v in ptxas.items() if "cavlc_residual_kernel" in k]
    if len(hits) != 1:
        fail(f"build.log: {len(hits)} ptxas reports match "
             f"cavlc_residual_kernel")
    out["ptxas"] = hits[0]
    out["worst"] = worst
    log(f"phase 2 ptxas cavlc_residual_kernel: {json.dumps(hits[0])}")
    return out


def cavlc_only():
    """--cavlc: phase 1's build of the kernels' library, then cavlc_phase
    alone on the bench's first two 1080p frames; prints its result and the
    card's name and power limit."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "card")
    sys.path.insert(0, ROOT)
    from bench import synth_clip
    from x264_tpu_torch.ops import _cuda
    t0 = time.time()
    lib = _cuda.build_library()
    log(f"build: {time.time() - t0:.2f} s")
    ptxas = ptxas_report(os.path.join(os.path.dirname(lib), "build.log"))
    res = cavlc_phase(torch, torch.device("cuda"), synth_clip(2), ptxas)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())
    print(json.dumps({"cavlc": res}), flush=True)


# --------------------------------- CLI, farm and mesh, CUDA == CPU (phase 3)
def cli_run(dev_name, work, name, src, extra):
    """The port's CLI on `src` with --device dev_name -> (output bytes,
    stats file text or None, host seconds)."""
    from x264_tpu_torch import cli
    out = os.path.join(work, f"{name}_{dev_name}.{extra[-1]}")
    opts = list(extra[:-1])
    stats = None
    if "--stats" in opts:
        k = opts.index("--stats") + 1
        stats = opts[k] = os.path.join(work, f"{opts[k]}_{dev_name}.log")
    t0 = time.time()
    rc = cli.main(["--device", dev_name, "--quiet"] + opts + ["-o", out, src])
    if rc != 0:
        fail(f"CLI {name} on {dev_name} exited {rc}")
    with open(out, "rb") as f:
        data = f.read()
    text = None
    if stats is not None:
        with open(stats) as f:
            text = f.read()
    return data, text, time.time() - t0


def y4m_clip(work, name, frames, w, h):
    """Write frames as a y4m (the port's Y4MWriter) -> its path."""
    from x264_tpu_torch.io.y4m import VideoInfo, Y4MWriter
    path = os.path.join(work, name + ".y4m")
    wr = Y4MWriter(path, VideoInfo(w, h, 25, 1))
    for f in frames:
        wr.write_frame(f)
    wr.close()
    return path


VBV_CLI = ["--bitrate", "1000", "--vbv-maxrate", "1000", "--vbv-bufsize",
           "200", "--nal-hrd", "cbr", "--filler"]


def farm_params(w, h):
    """The farm's scope: ippp_params (preset medium, IPPP, CQP 26, CAVLC)
    with weighted_pred 0."""
    p = ippp_params(w, h)
    p.analyse.weighted_pred = 0
    return p


def launch_counts():
    """(commit, deblock) kernel launches of this process so far."""
    from x264_tpu_torch.ops import commit as C
    from x264_tpu_torch.ops import deblock as D
    return C.commit.launches, D.deblock_frame.launches


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from x264_tpu_torch.ops import commit as C
    from x264_tpu_torch.ops import deblock as D
    from x264_tpu_torch.ops import motion as MO
    C.commit.launches = 0
    D.deblock_frame.launches = 0
    for fn in MO.LAUNCHES:
        fn.launches = 0
    cavlc_launch().launches = 0


def cavlc_launch():
    """ops/cavlc.py cavlc_residual_launch (its .launches count)."""
    from x264_tpu_torch.ops.cavlc import cavlc_residual_launch
    return cavlc_residual_launch


# the motion kernels: (name, wrapper in ops/motion.py, the scan replaced)
MOTION_KERNELS = (
    ("me_lowres_scan", "lowres_scan_launch",
     "x264_tpu/encoder/inter.py:208 (motion_search_seeded stage 1, jnp "
     "lax.scan)"),
    ("me_refine", "refine_launch",
     "x264_tpu/encoder/inter.py:248 (motion_search_seeded stage 2, jnp "
     "lax.scan)"),
    ("me_esa", "esa_launch",
     "x264_tpu/encoder/inter.py:86 (motion_search, jnp lax.scan)"),
    ("me_subpel", "subpel_launch",
     "x264_tpu/encoder/inter.py:351 (_subpel_refine_scan with "
     "_subpel_windows :400, jnp lax.scan)"))
SEEDED = ("me_lowres_scan", "me_refine", "me_subpel")   # seeded P paths
ESA_P = ("me_esa", "me_subpel")                         # esa / tesa P paths


def motion_counts():
    """Each motion kernel's launches in this process so far, by name."""
    from x264_tpu_torch.ops import motion as MO
    return {name: getattr(MO, fn).launches for name, fn, _ in MOTION_KERNELS}


def check_motion(label, counts, used):
    """Fail unless each motion kernel in `used` launched on the path (its
    counts read just after it ran, from 0 just before) and no other did."""
    bad = {k: v for k, v in counts.items() if (v > 0) != (k in used)}
    if bad:
        fail(f"{label}: motion kernel launches {counts}; expected launches "
             f"of exactly {list(used)}")


def add_launches(launches, n0):
    """Append the launches since launch_counts() gave n0 to `launches`
    ({"commit": [...], "deblock": [...]})."""
    for key, a, b in zip(("commit", "deblock"), n0, launch_counts()):
        launches[key].append(b - a)


def farm_run(torch, C, params, clips, dev, timer=None):
    """FarmEncoder over S clips (one per stream) on `dev` -> (streams,
    per-stream reconstructions (numpy) per frame position, launches per
    frame position ({"commit": [...], "deblock": [...]}), host seconds).
    With `timer` (a StageTimer's hooks), the farm's stage functions are
    timed while it runs."""
    import contextlib
    from x264_tpu_torch.encoder.encoder import annexb_bytes
    from x264_tpu_torch.encoder.farm import FarmEncoder
    farm = FarmEncoder(params, len(clips), device=dev)
    streams = [annexb_bytes(farm.headers()) for _ in clips]
    recons, launches = [[] for _ in clips], {"commit": [], "deblock": []}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx = (contextlib.nullcontext() if timer is None else StageTimer(
        torch, None, hooks=timer, dpb_push=False,
        extra=[(farm, "_dpb_entry", "dpb_push")]))
    t0 = time.time()
    with ctx as stages:
        for i in range(len(clips[0])):
            n0 = launch_counts()
            outs = farm.encode_batch([c[i] for c in clips], idr=(i == 0))
            add_launches(launches, n0)
            for s, nals in enumerate(outs):
                streams[s] += annexb_bytes(nals)
                recons[s].append([r.cpu().numpy() for r in farm.recon[s]])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    if timer is not None:
        n = len(clips[0])
        return streams, recons, launches, secs, {
            k: v / n for k, v in stages.ms.items()}
    return streams, recons, launches, secs


def mb_pad(frame, w, h):
    """Edge-pad planes to whole MBs, as the Encoder pads its input."""
    import numpy as np
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    return [np.pad(p, ((0, (H - h) // d), (0, (W - w) // d)), mode="edge")
            for p, d in zip(frame, (1, 2, 2))]


def mesh_run(torch, C, dev, i_frames, p_frames, band_mb_rows, qp=QP):
    """The mesh's I step, then its P step against the I step's
    reconstructions, on `dev` -> ([intra outputs, P outputs], launches of
    each step ({"commit": [...], "deblock": [...]}), host seconds of each
    step, the layout)."""
    import numpy as np
    from x264_tpu_torch.parallel import mesh
    m = mesh.make_mesh(8 if len(i_frames) > 1 else 4, devices=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out, launches, secs = [], {"commit": [], "deblock": []}, []
    for step in ("intra", "pframe"):
        n0 = launch_counts()
        sync()
        t0 = time.time()
        if step == "intra":
            r = mesh.sharded_intra_encode(m, i_frames, qp=qp,
                                          band_mb_rows=band_mb_rows)
            refs = [[np.concatenate(r[2][c][s].cpu().numpy(), axis=0)
                     for c in range(3)] for s in range(len(i_frames))]
        else:
            r = mesh.sharded_pframe_encode(m, p_frames, refs, qp=qp,
                                           band_mb_rows=band_mb_rows)
        sync()
        secs.append(time.time() - t0)
        add_launches(launches, n0)
        out.append(r)
    return out, launches, secs, m


def mesh_bytes(params, intra, pfr, s, band_mb_rows, qp=QP):
    """Headers, the banded IDR (no deblock) and the banded P frame
    (deblock inside each slice) of stream s."""
    from x264_tpu_torch.encoder.encoder import annexb_bytes
    from x264_tpu_torch.parallel.mesh import assemble_band_nals
    nals = headers_for(params)
    nals += assemble_band_nals(params, intra[0][s], intra[1][s],
                               band_mb_rows=band_mb_rows, slice_qp=qp,
                               deblock_idc=1)
    nals += assemble_band_nals(params, pfr[0][s], pfr[1][s],
                               band_mb_rows=band_mb_rows, slice_qp=qp,
                               frame_num=1, poc=2, idr=False, ptype=True,
                               deblock_idc=2)
    return annexb_bytes(nals)


def mesh_params(w, h):
    from x264_tpu_torch.encoder.encoder import validate_parameters
    return validate_parameters(ippp_params(w, h))


def headers_for(params):
    """SPS and PPS NALs of `params`."""
    from x264_tpu_torch.entropy import nal as nal_mod
    from x264_tpu_torch.entropy import sets
    sps = sets.sps_init(params, params.sps_id)
    pps = sets.pps_init(params, sps, params.sps_id)
    return [nal_mod.nal_encode(nal_mod.NAL_SPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.sps_write(sps)),
            nal_mod.nal_encode(nal_mod.NAL_PPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.pps_write(pps))]


def band_stream(intra, s, b, w, band_mb_rows, qp=QP):
    """Band b of stream s of the mesh's I step as the one slice of a
    w x band-height picture: a stream refdec can decode."""
    from x264_tpu_torch.encoder.encoder import annexb_bytes
    from x264_tpu_torch.parallel.mesh import assemble_band_nals
    p = mesh_params(w, 16 * band_mb_rows)
    return annexb_bytes(headers_for(p) + assemble_band_nals(
        p, intra[0][s, b:b + 1], intra[1][s, b:b + 1],
        band_mb_rows=band_mb_rows, slice_qp=qp, deblock_idc=1))


# ------------------------------------------ phase 3: CUDA == CPU, in a pool
# Phase 3 holds the card's bytes against the CPU's and times nothing. Its
# configurations are independent, so each runs as a case in a pool of
# worker processes, each with a CUDA context of its own (without MPS the
# contexts take the card in time slices, so a frame kernel's blocks are
# all resident whenever it runs). A case returns its log lines and the
# streams refdec is to decode; the main process starts those decoders as
# the cases end. The CPU encodes of the timed paths' first frames run in
# the same pool, after the timed paths.
def refresh_at_1(enc, i):
    """Under PIR, Encoder.intra_refresh() ahead of frame 1 starts the
    column sweep there (left alone it starts at frame keyint)."""
    if i == 1 and enc.p.intra_refresh:
        enc.intra_refresh()


def recon_frames(outs):
    import numpy as np
    return [[np.asarray(r) for r in o.recon] for o in outs]


def stream_case(label, p_dev, p_cpu, frames, dev_name, opts):
    """One configuration: `frames` through Encoder.encode on `dev_name`
    (params p_dev) and on the CPU (p_cpu); the streams must be equal.
    opts: want (the frame types), need_b (a B frame among them), no_8x8
    (no P_8x8 MB), refresh (refresh_at_1), ssim (each frame's SSIM equal
    within 1e-6), pir (frame 1 a keyframe), decode (refdec is to decode
    the stream to the reconstructions), motion (the motion kernels that
    must launch in the CUDA encode, and no other)."""
    from x264_tpu_torch.encoder.encoder import TYPE_B, Encoder, Picture
    before = refresh_at_1 if opts.get("refresh") else None
    enc_g = Encoder(p_dev, device=dev_name)
    reset_launches()
    t0 = time.time()
    s_gpu, o_gpu = encode_stream(enc_g, frames, Picture, before)
    t_gpu = time.time() - t0
    motion = motion_counts()
    if "motion" in opts and dev_name == "cuda":
        check_motion(f"phase 3 {label}", motion, opts["motion"])
    t0 = time.time()
    s_cpu, o_cpu = encode_stream(Encoder(p_cpu, device="cpu"), frames,
                                 Picture, before)
    t_cpu = time.time() - t0
    types = [o.i_type for o in o_gpu]
    if len(o_gpu) != len(frames) or types != opts.get("want", types) \
            or (opts.get("need_b") and TYPE_B not in types):
        fail(f"phase 3 {label}: {len(o_gpu)} frames, types {types}")
    if s_gpu != s_cpu:
        fail(f"phase 3 {label}: CUDA and CPU streams differ")
    mb = enc_g.stats.get("mb", {})
    if opts.get("no_8x8") and mb["P"]["8x8"] != 0:
        fail(f"phase 3 {label}: a CABAC frame coded P_8x8 MBs")
    extra = "" if "B" not in mb else f", B MBs {mb['B']}"
    if enc_g.stats.get("weightp_frames"):
        extra += f", weightp frames {enc_g.stats['weightp_frames']}"
    if opts.get("ssim"):
        d = max(abs(a.ssim - b.ssim) for a, b in zip(o_gpu, o_cpu))
        if d > 1e-6:
            fail(f"phase 3 {label}: SSIM CUDA vs CPU differs by {d}")
        extra += (f", SSIM {[round(o.ssim, 6) for o in o_gpu]} (CUDA vs "
                  f"CPU within {d:.2e})")
    if opts.get("pir"):
        extra += f", keyframes {[o.b_keyframe for o in o_gpu]}"
        if not o_gpu[1].b_keyframe:
            fail(f"phase 3 {label}: the queued refresh did not start a "
                 f"sweep at frame 1")
    if "motion" in opts:
        extra += f", motion kernel launches {motion}"
    line = (f"phase 3 {label}: CUDA stream == CPU stream ({len(s_gpu)} "
            f"bytes, types {types}, QPs {[o.qp for o in o_gpu]}, P MBs "
            f"{mb.get('P')}{extra}; CUDA {t_gpu:.1f} s, CPU {t_cpu:.1f} s)")
    decode = [(label, s_gpu, recon_frames(o_gpu), p_dev.width,
               p_dev.height)] if opts.get("decode") else []
    return {"log": [line], "decode": decode}


def cli_case(tag, work, src, configs, dev_name):
    """The port's CLI on `src` with --device dev_name and --device cpu,
    for each (name, options + [extension]) of `configs` in turn (a second
    pass reads the stats of the first): outputs and stats files equal."""
    lines = []
    for name, extra in configs:
        g, g_st, g_s = cli_run(dev_name, work, name, src, extra)
        c, c_st, c_s = cli_run("cpu", work, name, src, extra)
        if g != c or g_st != c_st:
            fail(f"{tag} {name} .{extra[-1]}: CUDA and CPU differ")
        lines.append(
            f"{tag} {name} .{extra[-1]}: CUDA output == CPU output "
            f"({len(g)} bytes" + ("" if g_st is None else ", stats files "
                                  "equal") +
            f"; CUDA {g_s:.1f} s, CPU {c_s:.1f} s)")
    return {"log": lines}


def farm_case(w, h, n, dev_name):
    """The farm (S = 2, n frames) on `dev_name` and on the CPU: streams
    equal, one commit and two deblock launches per frame position on the
    card; at 640 wide refdec is to decode each stream to the farm's
    reconstructions."""
    import torch
    from x264_tpu_torch.ops import commit as C
    dev = torch.device(dev_name)
    clips = [[mb_pad(f, w, h) for f in moving_frames(n, w, h, seed=s)]
             for s in (0, 1)]
    g_streams, g_rec, g_l, g_s = farm_run(torch, C, farm_params(w, h), clips,
                                          dev)
    c_streams, _, _, c_s = farm_run(torch, C, farm_params(w, h), clips,
                                    torch.device("cpu"))
    if g_streams != c_streams:
        fail(f"phase 3 farm {w}x{h}: CUDA and CPU streams differ")
    if dev.type == "cuda" and (g_l["commit"] != [1] * n
                               or g_l["deblock"] != [2] * n):
        fail(f"phase 3 farm {w}x{h}: launches per frame position {g_l}, "
             f"expected 1 commit and 2 deblocks (one per stream) each")
    decode = []
    if w == 640:
        decode = [(f"farm {w}x{h} stream {s}", st,
                   [[r[c][:h if c == 0 else h // 2, :w if c == 0 else w // 2]
                     for c in range(3)] for r in g_rec[s]], w, h)
                  for s, st in enumerate(g_streams)]
    return {"log": [
        f"phase 3 farm S=2 {w}x{h} x{n}: CUDA streams == CPU streams "
        f"({[len(st) for st in g_streams]} bytes); launches per frame "
        f"position {g_l}; CUDA {g_s:.1f} s, CPU {c_s:.1f} s"],
        "decode": decode}


def mesh_case(dev_name):
    """The mesh (2 streams x 4 bands of 2 MB rows, I then P) at 64x128 on
    `dev_name` and on the CPU: bytes and reconstructions equal, one commit
    launch for the I step and none for the P step on the card, and no
    deblock launch for the I step and one per band for the P step; refdec is
    to decode each intra band, coded as a frame of its own (refdec decodes
    no multi-slice stream), to its reconstruction."""
    import torch
    from x264_tpu_torch.ops import commit as C
    dev = torch.device(dev_name)
    frames = moving_frames(4, 64, 128, seed=9)
    g_out, g_l, g_s, _ = mesh_run(torch, C, dev, frames[:2], frames[2:], 2)
    c_out, _, c_s, _ = mesh_run(torch, C, torch.device("cpu"), frames[:2],
                                frames[2:], 2)
    p = mesh_params(64, 128)
    sizes = []
    for s in range(2):
        g_b = mesh_bytes(p, *g_out, s, 2)
        if g_b != mesh_bytes(p, *c_out, s, 2):
            fail(f"phase 3 mesh stream {s}: CUDA and CPU bytes differ")
        sizes.append(len(g_b))
    for step, a, b in zip(("intra", "P"), g_out, c_out):
        if not all(torch.equal(a[2][c].cpu(), b[2][c]) for c in range(3)):
            fail(f"phase 3 mesh {step}: CUDA and CPU reconstructions "
                 f"differ")
    if dev.type == "cuda" and (g_l["commit"] != [1, 0]
                               or g_l["deblock"] != [0, 8]):
        fail(f"phase 3 mesh: launches {g_l}, expected commit 1 (I step) "
             f"and 0 (P step), deblock 0 (I step) and 8 (P step: one per "
             f"band)")
    decode = [(f"mesh stream {s} intra band {b}",
               band_stream(g_out[0], s, b, 64, 2),
               [[g_out[0][2][c][s, b].cpu().numpy() for c in range(3)]],
               64, 32) for s in range(2) for b in range(4)]
    return {"log": [
        f"phase 3 mesh 2 streams x 4 bands 64x128, I then P: CUDA bytes == "
        f"CPU bytes ({sizes}), reconstructions equal; launches (I step, P "
        f"step) {g_l}; CUDA {sum(g_s):.1f} s, CPU "
        f"{sum(c_s):.1f} s"], "decode": decode}


def deblock_tall_case(dev_name):
    """The deblock kernel on a frame whose bands of MB rows outnumber the
    blocks that the card holds at once (2 MBs wide, capacity + 2 bands,
    the last a part band, so some blocks walk two bands) against
    deblock_ref on the CPU, bit-exact: random strengths, QPs over 0-51.
    The plain version takes tens of seconds here, which is why it runs in
    phase 3's pool. On the CPU (a rehearsal) the frame has 13 rows and
    deblock_frame is deblock_ref."""
    import numpy as np
    import torch
    from x264_tpu_torch.ops import deblock as D
    dev, cpu = torch.device(dev_name), torch.device("cpu")
    cap, rows = ((D.grid_capacity(dev), D.band_rows())
                 if dev.type == "cuda" else (2, 4))
    mbw, mbh = 2, rows * (cap + 1) + 1
    rng = np.random.default_rng(11)
    inputs = blocky_frame(torch, 16 * mbw, 16 * mbh, 11, cpu) + [
        torch.from_numpy(rng.integers(0, 5, (mbh, mbw, 4, 4))
                         .astype(np.int32)) for _ in range(2)] + [
        torch.from_numpy(rng.integers(0, 52, (mbh, mbw)).astype(np.int32))]
    kw = dict(mbw=mbw, mbh=mbh, a_off=6, b_off=-6, chroma_qp_offset=6)
    t0 = time.time()
    ref = D.deblock_ref(*inputs, **kw)
    ref_s = time.time() - t0
    n0 = D.deblock_frame.launches
    got = D.deblock_frame(*[t.to(dev) for t in inputs], **kw)
    launches = D.deblock_frame.launches - n0
    err = max(int((r.int() - g.cpu().int()).abs().max())
              for r, g in zip(ref, got))
    if err != 0 or launches != (dev.type == "cuda"):
        fail(f"phase 3 deblock kernel on {16 * mbw}x{16 * mbh}: max_abs_err "
             f"{err}, {launches} launches")
    return {"log": [
        f"phase 3 deblock kernel vs deblock_ref (CPU, {ref_s:.1f} s) "
        f"{16 * mbw}x{16 * mbh}: {mbh} MB rows, {-(-mbh // rows)} bands of "
        f"{rows} on {cap} co-resident blocks in {launches} launch: "
        f"max_abs_err {err} (tolerance 0)"]}


def cpu_prefix(key, params, frames):
    """The CPU port's stream of `frames` (the first frames of a timed
    path's clip) -> {"prefix": (key, stream, host seconds)}."""
    from x264_tpu_torch.encoder.encoder import Encoder, Picture
    t0 = time.time()
    stream, _ = encode_stream(Encoder(params, device="cpu"), frames, Picture)
    return {"prefix": (key, stream, time.time() - t0)}


def cpu_default_frame0(key, params, frames):
    """The CPU port's headers and first picture of the default path: its
    lookahead takes all of `frames` (MB-tree reaches frame 0 from them),
    then only the IDR is dispatched."""
    from x264_tpu_torch.encoder.encoder import (TYPE_IDR, Encoder, Picture,
                                                annexb_bytes)
    enc = Encoder(params, device="cpu")
    t0 = time.time()
    stream = annexb_bytes(enc.headers())
    for i, f in enumerate(frames):
        enc.encode(Picture(f, pts=i))
    enc._pipe_depth = 0               # the flush call dispatches one frame
    nals, out = enc.encode(None)
    stream += annexb_bytes(nals)
    if out is None or out.i_type != TYPE_IDR:
        fail("the CPU port's first default-path picture is no IDR")
    return {"prefix": (key, stream, time.time() - t0), "qp": out.qp}


def phase3_cases(dev_name, mid):
    """Phase 3's cases, (key, function, arguments), the longest first:
    the deblock kernel on a frame taller than its co-resident grid (its
    plain version takes a minute on the CPU), the 640x360 option
    configurations (their refdec takes longest), the
    defaults over 28 frames, the 640x360 farm and paths, the CLI and the
    mesh, then the 64x48 configurations."""
    import numpy as np
    from x264_tpu_torch.encoder.encoder import TYPE_B, TYPE_IDR, TYPE_P
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:48, 0:64]
    frames3 = []
    for i in range(3):
        y = np.clip(128 + 60 * np.sin(xx / 23 + i) * np.cos(yy / 17)
                    + rng.integers(-8, 8, (48, 64)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31 + i), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29 - i), 0,
                    255).astype(np.uint8)
        frames3.append([y, u, v])
    mov = moving_frames(5, 64, 48)
    mov7 = moving_frames(7, 64, 48)
    mov28 = moving_frames(28, 64, 48, seed=3)
    ippp = [TYPE_IDR] + [TYPE_P] * 4
    ibbp = [TYPE_IDR, TYPE_P, TYPE_B, TYPE_B, TYPE_P, TYPE_B, TYPE_B]
    options = (
        ("veryfast", preset_params("veryfast"), {}),
        ("fast", preset_params("fast"), {}),
        ("NR 200", option_params(analyse__noise_reduction=200), {}),
        ("PIR keyint 8", option_params(intra_refresh=True, keyint_max=8),
         {"pir": True}),
        # tests/test_pcm_e2e.py's preset: refdec filters I_PCM MBs when the
        # deblock is on (libavcodec does not), so it stays off
        ("PCM", pcm_params, {}),
        ("SSIM", option_params(analyse__ssim=True), {"ssim": True}))
    big, small = [("deblock tall frame", deblock_tall_case, (dev_name,))], []

    def add(to, label, make, frames, **opts):
        h, w = frames[0][0].shape
        p_dev = make(w, h)
        p_dev.full_recon = True
        to.append((label, stream_case, (label, p_dev, make(w, h), frames,
                                        dev_name, opts)))

    for label, make, opts in options:
        add(big, f"{label} 640x360 x3", make, mid[:3], refresh=True,
            decode=True, **opts)
        add(small, f"{label} 64x48 x5", make, mov, refresh=True, **opts)
    # the ESA at the presets' largest range (veryslow, placebo: tesa, 24)
    add(big, "tesa me_range 24 640x360 x3",
        option_params(analyse__me_method=4, analyse__me_range=24), mid[:3],
        motion=ESA_P)
    add(big, "64x48 defaults (CRF, MB-tree, AQ, adaptive B) x28",
        default_params, mov28, need_b=True, decode=True)
    big.append(("farm 640x360", farm_case, (640, 360, 3, dev_name)))
    add(big, "640x360 IPPP x4", ippp_params, mid, want=ippp[:4])
    add(big, "640x360 IPPP CABAC x4", cabac_params, mid, want=ippp[:4],
        no_8x8=True)
    add(big, "640x360 IBBP CAVLC x4", lambda w, h: ibbp_params(w, h, False),
        mid, want=ibbp[:4])
    add(big, "640x360 IBBP CABAC x4", lambda w, h: ibbp_params(w, h, True),
        mid, want=ibbp[:4])
    work = os.path.join(ROOT, "x264_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    src = y4m_clip(work, "cli64", moving_frames(5, 64, 48, seed=3), 64, 48)
    for key, configs in (
            ("CLI defaults", (("defaults", ["264"]), ("defaults", ["mkv"]),
                              ("defaults", ["mp4"]))),
            ("CLI vbv, aud", (("vbv", VBV_CLI + ["264"]),
                              ("aud", ["--aud", "264"]))),
            ("CLI two passes", (("pass1", ["--bitrate", "200", "--pass", "1",
                                           "--stats", "st", "264"]),
                                ("pass2", ["--bitrate", "200", "--pass", "2",
                                           "--stats", "st", "264"])))):
        big.append((key, cli_case, ("phase 3 CLI 64x48 x5", work, src,
                                    configs, dev_name)))
    big.append(("mesh 64x128", mesh_case, (dev_name,)))
    add(small, "64x48 x3", intra_params, frames3, decode=True)
    add(small, "64x48 IPPP x5", ippp_params, mov, want=ippp, decode=True)
    add(small, "64x48 IPPP CABAC x5", cabac_params, mov, want=ippp,
        no_8x8=True, decode=True)
    add(small, "64x48 IPPP CABAC CRF+AQ x5", crf_aq_params, mov, want=ippp,
        no_8x8=True, decode=True)
    add(small, "64x48 IBBP CAVLC x7", lambda w, h: ibbp_params(w, h, False),
        mov7, want=ibbp, decode=True)
    add(small, "64x48 IBBP CABAC x7", lambda w, h: ibbp_params(w, h, True),
        mov7, want=ibbp, decode=True)
    small.append(("farm 64x48", farm_case, (64, 48, 3, dev_name)))
    return big, small


def pool_init(threads):
    import torch
    torch.set_num_threads(threads)


def cuda_cpu_phase(dev_name, mid, first, later):
    """Phase 3: phase3_cases and the timed paths' CPU encodes (`first` go
    ahead of the 640x360 cases, `later` after them) in a pool of worker
    processes; refdec on the streams they name, each in a process of its
    own, started as the cases end. Prints every case's lines in the order
    of the cases, then the decoders'. Returns each case's result by key."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, as_completed
    ncpu = len(os.sched_getaffinity(0))
    workers = max(1, min(4, ncpu // 2))
    big, small = phase3_cases(dev_name, mid)
    cases = list(first) + big + list(later) + small
    pool = ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                               initializer=pool_init,
                               initargs=(max(1, ncpu // workers),))
    CHILDREN.append(pool)
    futs = {pool.submit(fn, *args): key for key, fn, args in cases}
    results, decoding = {}, []
    for fut in as_completed(futs):
        key = futs[fut]
        try:
            results[key] = fut.result()
        except BaseException as e:      # a case's fail() exits its worker
            fail(f"phase 3 case {key!r} failed: {e!r}")
        for tag, stream, frames, w, h in results[key].get("decode", ()):
            decoding.append((tag, refdec_start(stream, f"p3_{len(decoding)}"),
                             frames, w, h))
    pool.shutdown()
    CHILDREN.remove(pool)
    log(f"phase 3: {len(cases)} cases in {workers} worker processes")
    for key, _, _ in cases:
        for line in results[key].get("log", ()):
            log(line)
    for tag, job, frames, w, h in decoding:
        decoded, dec_s = refdec_finish(job, w, h)
        if not same_frames(decoded, frames):
            fail(f"phase 3 {tag}: refdec does not decode the CUDA stream to "
                 f"its reconstruction")
        log(f"phase 3 {tag}: refdec decodes the CUDA stream to the CUDA "
            f"reconstruction ({dec_s:.1f} s)")
    return results


# ------------------------------------------- phase 10: farm, mesh, CLI at 1080p
FARM_HOOKS = (("intra", "decide_iframe", "decide"),
              ("inter", "p_analyse", "analyse"),
              ("farm", "commit_batch", "commit_batched"),
              ("intra", "iframe_cavlc_tail", "cavlc_deblock"),
              ("inter", "p_merge_levels", "merge_cbp_skip"),
              ("inter", "p_finish", "cavlc_deblock"),
              ("intra", "finalize_slice", "finalize_slice"))
MESH_HOOKS = (("intra", "decide_iframe", "decide"),
              ("mesh", "commit_batch", "commit_batched"),
              ("intra", "iframe_cavlc_tail", "cavlc"),
              ("inter", "encode_pframe", "p_band"))
N_FARM_FRAMES = 3     # 1080p farm: I P P per stream
N_CLI_FRAMES = 6      # 1080p CLI: ultrafast IPPPPP


def psnr_y(a, b):
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def full_width_phase(torch, C, dev, clip, w=1920, h=1080, band_rows=17):
    """Phase 10: the farm (S = 2, I P P at the farm's scope: preset medium
    IPPP, CQP 26, CAVLC, weighted_pred 0; stream 0 the bench's clip,
    stream 1 the same clip mirrored), the mesh (1 stream x 4 bands of 17
    MB rows, I then P) and the CLI (a 6-frame y4m written by the port's
    Y4MWriter, preset ultrafast, ABR with VBV and nal-hrd cbr, to .mp4) at
    1920x1080 on the card: fps, commit launches per frame position (1),
    stage times, bytes; PSNR of every reconstruction; the CLI's first two
    frames equal a CPU run's."""
    import numpy as np
    frames0 = [mb_pad(f, w, h) for f in clip[:N_FARM_FRAMES]]
    frames1 = [[np.ascontiguousarray(p[:, ::-1]) for p in f]
               for f in frames0]
    clips = [frames0, frames1]
    res = {}
    # ---- farm: fps from a run without the stage timer, stages from a
    # second run (its streams must equal the first's) ----
    reset_launches()
    streams, recons, launches, secs = farm_run(
        torch, C, farm_params(w, h), clips, dev)
    farm_motion = motion_counts()
    check_motion("phase 10 farm", farm_motion, SEEDED)
    if launches["commit"] != [1] * N_FARM_FRAMES or \
            launches["deblock"] != [2] * N_FARM_FRAMES or \
            launch_counts() != (N_FARM_FRAMES, 2 * N_FARM_FRAMES):
        fail(f"phase 10 farm: launches per frame position {launches}, "
             f"expected 1 commit and 2 deblocks (one per stream) each")
    again, _, _, t_secs, stages = farm_run(
        torch, C, farm_params(w, h), clips, dev, timer=FARM_HOOKS)
    if again != streams:
        fail("phase 10 farm: the timed run's streams differ")
    psnr = [[round(psnr_y(r[0][:h], c[i][0][:h]), 2)
             for i, r in enumerate(rs)] for rs, c in zip(recons, clips)]
    if min(min(p) for p in psnr) < 30:
        fail(f"phase 10 farm: PSNR Y {psnr}")
    res["farm"] = {"fps": N_FARM_FRAMES * 2 / secs, "launches": launches,
                   "stages": stages, "motion": farm_motion}
    log(f"phase 10 farm S=2 x {N_FARM_FRAMES} x 1080p (I P P, one batched "
        f"commit per frame position): fps {res['farm']['fps']:.4f} (frames "
        f"x streams / s; {secs:.3f} s, first position included); "
        f"launches per frame position {launches}, motion kernel launches "
        f"{farm_motion}; bytes "
        f"{[frame_bytes(s) for s in streams]}; PSNR Y {psnr}; stages ms per "
        f"frame position (a second run, {t_secs:.3f} s, streams equal; host "
        f"clock, synchronised around each stage): " + json.dumps(stages))
    # ---- mesh: the same, fps untimed, stages from a second run ----
    reset_launches()
    (intra_o, p_o), m_l, m_s, layout = mesh_run(
        torch, C, dev, [frames0[0]], [frames0[1]], band_rows)
    mesh_motion = motion_counts()
    check_motion("phase 10 mesh", mesh_motion, ESA_P)
    if m_l["commit"] != [1, 0] or m_l["deblock"] != [0, 4] or \
            launch_counts() != (1, 4):
        fail(f"phase 10 mesh: launches {m_l}, expected commit 1 and 0, "
             f"deblock 0 and 4 (one per band)")
    # the batched entry of the kernel line: the mesh I step's launches
    res["launches"] = m_l["commit"][0]
    with StageTimer(torch, None, hooks=MESH_HOOKS, dpb_push=False) as timer:
        (intra_t, p_t), _, m_ts, _ = mesh_run(
            torch, C, dev, [frames0[0]], [frames0[1]], band_rows)
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in
               ((intra_o[0], intra_t[0]), (p_o[0], p_t[0]))):
        fail("phase 10 mesh: the timed run's words differ")
    rec_i = [np.concatenate(intra_o[2][c][0].cpu().numpy(), axis=0)
             for c in range(3)]
    rec_p = [np.concatenate(p_o[2][c][0].cpu().numpy(), axis=0)
             for c in range(3)]
    m_psnr = [round(psnr_y(rec_i[0], frames0[0][0]), 2),
              round(psnr_y(rec_p[0], frames0[1][0]), 2)]
    if min(m_psnr) < 30:
        fail(f"phase 10 mesh: PSNR Y {m_psnr}")
    hb = 4 * 16 * band_rows
    m_bytes = mesh_bytes(mesh_params(w, hb), intra_o, p_o, 0, band_rows)
    res["mesh"] = {"fps": 2 / sum(m_s), "launches": m_l,
                   "stages": timer.ms, "motion": mesh_motion}
    log(f"phase 10 mesh 1 stream x 4 bands of 17 MB rows at 1080p (layout "
        f"{layout.shape} of make_mesh(4); I step, then P step): fps "
        f"{res['mesh']['fps']:.4f} ({m_s[0]:.3f} s I, {m_s[1]:.3f} s P); "
        f"launches (I step, P step) {m_l}, motion kernel launches "
        f"{mesh_motion}; {len(m_bytes)} bytes (band bits I "
        f"{intra_o[1][0].tolist()}, P {p_o[1][0].tolist()}); PSNR Y "
        f"{m_psnr}; stages ms (a second run, {sum(m_ts):.3f} s, words "
        f"equal; host clock, synchronised around each stage): "
        + json.dumps(timer.ms))
    # ---- CLI ----
    work = os.path.join(ROOT, "x264_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    src = y4m_clip(work, "cli1080", clip[:N_CLI_FRAMES], w, h)
    opts = ["--preset", "ultrafast", "--bitrate", "8000", "--vbv-maxrate",
            "8000", "--vbv-bufsize", "16000", "--nal-hrd", "cbr"]
    reset_launches()
    out, _, secs = cli_run("cuda", work, "cli1080", src, opts + ["mp4"])
    cli_launches, cli_deblocks = launch_counts()
    cli_motion = motion_counts()
    check_motion("phase 10 CLI", cli_motion, SEEDED)
    if cli_launches != N_CLI_FRAMES:
        fail(f"phase 10 CLI: {cli_launches} commit launches for "
             f"{N_CLI_FRAMES} frames")
    if cli_deblocks != 0:
        fail(f"phase 10 CLI: {cli_deblocks} deblock launches at ultrafast "
             f"(no deblock)")
    with StageTimer(torch, None, dpb_push=False) as timer:
        again, _, _ = cli_run("cuda", work, "cli1080t", src, opts + ["mp4"])
    if again != out:
        fail("phase 10 CLI: the timed run's output differs")
    res["cli"] = {"fps": N_CLI_FRAMES / secs, "launches": cli_launches,
                  "deblocks": cli_deblocks, "motion": cli_motion,
                  "stages": timer.ms, "calls": timer.calls}
    log(f"phase 10 CLI 1080p x{N_CLI_FRAMES} (y4m by Y4MWriter, preset "
        f"ultrafast, ABR 8000 kb/s, VBV, nal-hrd cbr, .mp4; "
        f"cli.main --device cuda): fps {res['cli']['fps']:.4f} ({secs:.3f} "
        f"s, reading and muxing included); commit launches {cli_launches} "
        f"(1 per frame), deblock launches {cli_deblocks}, motion kernel "
        f"launches {cli_motion}; {len(out)} bytes; "
        f"stages ms summed over the "
        f"clip, and their calls (a second run, output equal): "
        + json.dumps(res["cli"]["stages"]) + " "
        + json.dumps(res["cli"]["calls"]))
    # its first two frames, on the card and on the CPU: a case of phase 3
    res["cli_case"] = ("CLI 1080p frames 0-1", cli_case, (
        "phase 10 CLI 1080p", work, src,
        (("frames 0-1", opts + ["--frames", "2", "264"]),), "cuda"))
    return res


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "card")
    sys.path.insert(0, ROOT)
    from bench import synth_clip
    from x264_tpu_torch.encoder.encoder import (TYPE_B, TYPE_IDR, TYPE_P,
                                                Encoder, Picture)
    from x264_tpu_torch.encoder import bframe
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.ops import commit as C
    from x264_tpu_torch.ops import deblock as D
    from x264_tpu_torch.ops import motion as MO

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # ---- phase 1: build ----
    mark("start")
    import threading
    from x264_tpu_torch.entropy import cabac_host
    cabac_build = {}

    def build_cabac():
        t = time.time()
        try:
            cabac_host._load()
        except Exception as e:          # reported by the main thread
            cabac_build["error"] = e
        cabac_build["s"] = time.time() - t

    t0 = time.time()
    th = threading.Thread(target=build_cabac)
    th.start()
    lib = C.build_library()
    C._library()
    D._library()
    MO._library()
    cap = C.grid_capacity(dev)
    log(f"phase 1 build: {time.time() - t0:.2f} s -> "
        f"{os.path.relpath(lib, ROOT)} (csrc/commit.cu, csrc/deblock.cu, "
        f"csrc/motion.cu and csrc/cavlc.cu, one nvcc each, started "
        f"together); frame kernel: "
        f"{cap} co-resident "
        f"blocks; deblock kernel: {D.grid_capacity(dev)} blocks of "
        f"{D.band_rows()} MB rows")
    th.join()
    if "error" in cabac_build:
        fail(f"csrc/cabac.cpp did not build or load: {cabac_build['error']}")
    log(f"phase 1 build: csrc/cabac.cpp (g++, started with nvcc) built and "
        f"loaded in {cabac_build['s']:.2f} s")
    build_log = os.path.join(os.path.dirname(lib), "build.log")
    with open(build_log) as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                log("phase 1 ptxas: " + line.strip())
    ptxas = ptxas_report(build_log)
    sms, mhz = set_int_peak(torch)
    log(f"phase 1 integer peak: {sms} SMs x {LANE_OPS_PER_SM_CLOCK} lane "
        f"instructions a clock x {mhz:.0f} MHz (nvidia-smi clocks.max.sm) = "
        f"{INT_OPS_PER_S:.4e} /s")
    esa_loop = sass_loop(lib, "me_fullpel_kernelILi256ELi1E")
    log("phase 1 SASS of me_fullpel_kernel<256, 1> (the ESA), its "
        "innermost loop with __vsadu4: " + (esa_loop if isinstance(
            esa_loop, str) else f"{esa_loop[0]} instructions, "
            f"{esa_loop[1]} VABSDIFF4 (motion_bound counts 1 a VABSDIFF4 "
            f"and {OPS_PER_OFFSET[1]} an offset): {json.dumps(esa_loop[2])}"))

    mark("1 build")
    clip = synth_clip(max(N_DEFAULT_FRAMES, N_PIR_FRAMES))
    # ---- phase 8 (first): the default path, 5 x 1080p with B frames.
    # refdec, started on its stream in a process of its own at the lowest
    # priority on one core, takes minutes: it runs beside the phases that
    # follow and is waited for after phase 3 ----
    p8 = default_params(1920, 1080)
    clip8 = clip[:N_DEFAULT_FRAMES]
    adaptive_types = decided_types(p8, clip8, dev)
    if TYPE_B in adaptive_types:
        log(f"phase 8: the adaptive B-run decision codes {adaptive_types}")
    else:
        p8.bframe_adaptive = 0
        log(f"phase 8: the adaptive B-run decision (B_ADAPT_FAST) codes no "
            f"B frame on this clip ({adaptive_types}): the phase runs with "
            f"bframe_adaptive = 0, everything else at its default")
    p8.analyse.psnr = True
    enc8 = Encoder(p8, device=dev)
    # the first B frame's deblock inputs, kept for phase 2 (one clone)
    b_deblock, b_esa, b_subpel = [], [], []
    restore = [capture_calls(bframe, "deblock_frame", b_deblock),
               capture_calls(bframe, "motion_search", b_esa, 2),
               capture_calls(bframe, "subpel_refine_mc", b_subpel, 2)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    stream8, outs8 = encode_stream(enc8, clip8, Picture)
    torch.cuda.synchronize()
    wall8 = time.time() - t0
    launches_d, deblocks_d = launch_counts()
    motion = {"defaults": motion_counts()}
    cavlc = {"defaults": cavlc_launch().launches}
    for r in restore:
        r()
    refdec8 = refdec_start(stream8, "default", background=True)
    types8 = [o.i_type for o in outs8]
    n_ip = sum(t != TYPE_B for t in types8)
    log(f"phase 8 default path: {len(outs8)} frames, types {types8} (coding "
        f"order), pts {[o.pts for o in outs8]}, {len(stream8)} bytes, bytes "
        f"by type {enc8.stats['bytes_by_type']}, bytes per frame "
        f"{frame_bytes(stream8)}, QPs {[o.qp for o in outs8]}, commit "
        f"launches {launches_d} (I + P frames: {n_ip}), deblock launches "
        f"{deblocks_d} (frames: {len(outs8)}), B MBs "
        f"{enc8.stats['mb'].get('B')} (direct counts the skipped MBs too), "
        f"P MBs {enc8.stats['mb']['P']}, weightp frames "
        f"{enc8.stats.get('weightp_frames', 0)}, motion kernel launches "
        f"{motion['defaults']}")
    check_motion("phase 8 default path", motion["defaults"],
                 ("me_lowres_scan", "me_refine", "me_esa", "me_subpel"))
    if len(outs8) != N_DEFAULT_FRAMES or types8[0] != TYPE_IDR:
        fail(f"default path: {len(outs8)} frames, types {types8}")
    if TYPE_B not in types8:
        fail(f"default path: no B frame among {types8}")
    # CRF sets the QPs, so a re-encode cannot be read off them: the path
    # must simply make one launch per I or P frame and none per B frame
    if launches_d != n_ip:
        fail(f"commit launches {launches_d} != {n_ip} I and P frames")
    if deblocks_d < len(outs8) or not b_deblock:
        fail(f"default path: {deblocks_d} deblock launches for "
             f"{len(outs8)} deblocked frames, B deblock calls seen "
             f"{len(b_deblock)}")
    for o in outs8:
        shapes = [tuple(np.asarray(r).shape) for r in o.recon]
        if shapes != [(1080, 1920), (540, 960), (540, 960)]:
            fail(f"recon shapes {shapes}")
        if not all(np.isfinite(x) and x > 30.0 for x in o.psnr):
            fail(f"PSNR {o.psnr} (expected finite and > 30 dB)")
    log("phase 8 PSNR Y/U/V per frame: "
        + " ".join(f"{o.psnr[0]:.2f}/{o.psnr[1]:.2f}/{o.psnr[2]:.2f}"
                   for o in outs8))
    # the timed paths' first frames against the CPU port's: cases of phase
    # 3 (`prefixes`: key -> the path's stream, which must begin with the
    # CPU's); the CPU port's frame 0 of the default path sees all of the
    # clip in its lookahead, then dispatches only the IDR
    pc8 = default_params(1920, 1080)
    pc8.bframe_adaptive = p8.bframe_adaptive
    key8 = "phase 8 1080p default frame 0"
    first_cases = [(key8, cpu_default_frame0, (key8, pc8, clip8))]
    later_cases, prefixes = [], {key8: stream8}

    # ---- phase 2: kernels vs plain version on the card ----
    mark("8 default path (B frames, MB-tree)")
    enc_big = Encoder(intra_params(1920, 1080), device=dev)
    qp_i = enc_big.rc.start(TYPE_IDR, -1, frame_idx=0)   # via ip_factor
    rng = np.random.default_rng(5)

    def random_planes(w, h):
        return [rng.integers(0, 256, s).astype(np.uint8)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]

    tall_h = 16 * (cap + 5)
    sizes = [("64x48", 64, 48, random_planes(64, 48)),
             ("48x32", 48, 32, random_planes(48, 32)),
             ("1920x1088", 1920, 1080, clip[0]),
             (f"256x{tall_h}", 256, tall_h,
              synth_clip(1, w=256, h=tall_h)[0])]
    worst = 0
    timing_args = None
    for label, w, h, frame in sizes:
        enc = enc_big if w == 1920 else Encoder(intra_params(w, h),
                                                device=dev)
        planes = enc._pad_to_mb(frame)
        for variant, mixed, with_i4 in VARIANTS:
            args, kw = commit_inputs(torch, enc, planes, qp_i, seed=7,
                                     mixed=mixed, with_i4=with_i4)
            ref, ref_ms = timed_ref(torch, C, args, kw)
            runs = [("frame kernel", C.commit_cuda(*args, **kw))]
            if label == "1920x1088":
                runs.append(("frame kernel, 7 blocks",
                             C.commit_cuda(*args, grid=7, **kw)))
                if variant == "i16+i4":
                    runs.append(("per-diagonal kernel",
                                 C.commit_cuda_diag(*args, **kw)))
            torch.cuda.synchronize()
            n_i4 = int(kw["i4_mask"].sum()) if "i4_mask" in kw else 0
            for kname, got in runs:
                err = max_abs_err(ref, got)
                worst = max(worst, err)
                log(f"phase 2 {kname} vs commit_ref {label} {variant}: "
                    f"max_abs_err {err} (tolerance 0), MB rows "
                    f"{args[8]}, I4 MBs {n_i4}")
                if err != 0:
                    fail(f"{kname} disagrees with commit_ref ({label} "
                         f"{variant})")
            if label == "1920x1088" and variant == "i16+i4":
                timing_args = (args, kw, ref, ref_ms)

    mark("2 kernel vs commit_ref, 4 sizes x 4 variants")
    # the mixed variant on real P frames: the arguments of the commit that
    # the encoder's own dispatch of frame 1 (against frame 0's
    # reconstruction) makes, at preset medium (with I_4x4) and at
    # ultrafast (without)
    real_p, p_deblock = {}, []
    for variant, make in (("mixed+i4", ippp_params),
                          ("mixed", ultrafast_params)):
        enc_p = Encoder(make(1920, 1080), device=dev)
        enqueue(enc_p, clip[0], TYPE_IDR, 0)
        pargs, pkw = captured_commit(
            enc_p, clip[1], 1,
            deblock_calls=p_deblock if variant == "mixed+i4" else None)
        del enc_p
        if ("i4_mask" in pkw) != (variant == "mixed+i4"):
            fail(f"the {variant} P frame's commit has the wrong variant")
        real_p[variant] = real_p_commit(torch, C, variant, pargs, pkw)
        worst = max(worst, real_p[variant]["max_abs_err"])

    args, kw, ref, plain_ms = timing_args
    bound_ms, bound_by, nbytes, ops = commit_bound(args, kw, ref)

    def run_old():
        C.commit_cuda_diag(*args, **kw)

    progs = []

    def run_new():
        progs.append(C.commit_launch(*args, **kw)[2])

    for fn in (run_old, run_new):
        cuda_ms(torch, fn, 3)                      # warm-up
    old_ms = [cuda_ms(torch, run_old, 20)]
    new_ms = [cuda_ms(torch, run_new, 20), cuda_ms(torch, run_new, 20)]
    old_ms.append(cuda_ms(torch, run_old, 20))
    for prog in progs:
        C.check_progress(prog, args[7])
    k_ms = sum(new_ms) / len(new_ms)
    e_ms = sum(old_ms) / len(old_ms)
    p_ms = plain_ms
    log(f"phase 2 commit per 1080p frame (I16+I4, CUDA events, 20 runs "
        f"each; old, new, new, old): per-diagonal kernel {old_ms[0]:.4f} / "
        f"{old_ms[1]:.4f} ms, frame kernel {new_ms[0]:.4f} / "
        f"{new_ms[1]:.4f} ms; commit_ref {plain_ms:.1f} ms (1 run); "
        f"bound {bound_ms * 1e3:.3f} us by "
        f"{bound_by} ({nbytes} bytes, {ops} integer ops)")
    split = launch_split(torch, C, args, kw)
    log("phase 2 per-diagonal kernel, launch vs work (us per launch): "
        + json.dumps(split))
    log("phase 2 frame kernel, MB step and row hand-off (us): "
        + json.dumps(latency_model(torch, C, dev, rng)))
    for grid in (None, 7):
        log(f"phase 2 frame kernel, where a 1080p I16+I4 frame's time goes "
            f"({grid or 'all'} blocks): "
            + json.dumps(kernel_stats(torch, C, args, kw, grid)))
    mark("2 real P frames, timing, latency, counters")
    batched = batched_phase(torch, C, dev, rng, clip, enc_big, qp_i, cap)
    worst = max(worst, batched["worst"])
    mark("2 the batched launch")
    if len(p_deblock) != 1:
        fail(f"P frame 1 at preset medium made {len(p_deblock)} deblock "
             f"calls, expected 1")
    dbk = deblock_phase(torch, D, dev, rng, timing_args, p_deblock[0],
                        b_deblock[0])
    mark("2 the deblock kernel")
    if len(b_esa) != 2 or len(b_subpel) != 2:
        fail(f"the default path's first B frame made {len(b_esa)} ESA and "
             f"{len(b_subpel)} qpel refine calls, expected 2 each")
    mot = motion_phase(torch, dev, clip, (b_esa, b_subpel))
    mot["ptxas"] = {k: motion_ptxas(ptxas, k, mot.get(k, {}).get("args"))
                    for k, _, _ in MOTION_KERNELS}
    for k, report in mot["ptxas"].items():
        log(f"phase 2 ptxas {k}: {json.dumps(report)}")
    del b_esa, b_subpel
    mark("2 the motion kernels")
    cav = cavlc_phase(torch, dev, clip, ptxas)
    mark("2 the CAVLC kernel")

    # ---- phase 4: the all-intra path, 2 x 1080p through Encoder.encode --
    p4 = intra_params(1920, 1080)
    p4.analyse.psnr = True
    enc = Encoder(p4, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    stream, outs = encode_stream(enc, clip[:N_FRAMES], Picture)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, deblocks = launch_counts()
    motion["all-intra"] = motion_counts()
    cavlc["all-intra"] = cavlc_launch().launches
    retries = sum((o.qp - qp_i) // 4 for o in outs)
    log(f"phase 4 all-intra path: {len(outs)} frames, {len(stream)} bytes, "
        f"QPs {[o.qp for o in outs]}, commit launches {launches} "
        f"(= {N_FRAMES} frames + {retries} re-encodes), deblock launches "
        f"{deblocks}, motion kernel launches {motion['all-intra']}")
    check_motion("phase 4 all-intra path", motion["all-intra"], ())
    if len(outs) != N_FRAMES:
        fail(f"{len(outs)} frames out of {N_FRAMES}")
    if launches != N_FRAMES + retries:
        fail(f"commit launches {launches} != {N_FRAMES} + {retries}")
    if deblocks < N_FRAMES:
        fail(f"deblock launches {deblocks} < {N_FRAMES} deblocked frames")
    for o in outs:
        shapes = [tuple(np.asarray(r).shape) for r in o.recon]
        if shapes != [(1080, 1920), (540, 960), (540, 960)]:
            fail(f"recon shapes {shapes}")
        if not all(np.isfinite(x) and x > 30.0 for x in o.psnr):
            fail(f"PSNR {o.psnr} (expected finite and > 30 dB)")
    log("phase 4 PSNR Y/U/V per frame: "
        + " ".join(f"{o.psnr[0]:.2f}/{o.psnr[1]:.2f}/{o.psnr[2]:.2f}"
                   for o in outs))
    # a CPU encode of frame 0 alone (headers and the IDR), which is how
    # the path's own stream must begin: a case of phase 3
    key = "phase 4 1080p frame 0"
    later_cases.append((key, cpu_prefix, (key, intra_params(1920, 1080),
                                          clip[:1])))
    prefixes[key] = stream

    # ---- phase 5: the P main path, IDR + 3 P at 1080p ----
    mark("4 all-intra path")
    p5 = ippp_params(1920, 1080)
    p5.analyse.psnr = True
    enc5 = Encoder(p5, device=dev)
    qp_p = Encoder(p5, device=dev).rc.start(TYPE_P, -1, frame_idx=1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    stream5, outs5 = encode_stream(enc5, clip[:N_P_FRAMES], Picture)
    torch.cuda.synchronize()
    wall5 = time.time() - t0
    launches_p, deblocks_p = launch_counts()
    motion["IPPP"] = motion_counts()
    cavlc["IPPP"] = cavlc_launch().launches
    types = [o.i_type for o in outs5]
    nominal = {TYPE_IDR: qp_i, TYPE_P: qp_p}
    retries5 = sum((o.qp - nominal.get(o.i_type, qp_p)) // 4 for o in outs5)
    log(f"phase 5 P main path: {len(outs5)} frames, types {types}, "
        f"{len(stream5)} bytes, bytes by type "
        f"{enc5.stats['bytes_by_type']}, QPs {[o.qp for o in outs5]}, "
        f"commit launches {launches_p} (= {N_P_FRAMES} frames + "
        f"{retries5} re-encodes), deblock launches {deblocks_p}, P MBs "
        f"{enc5.stats['mb']['P']}, weightp "
        f"frames {enc5.stats.get('weightp_frames', 0)}, motion kernel "
        f"launches {motion['IPPP']}")
    check_motion("phase 5 P main path", motion["IPPP"], SEEDED)
    if types != [TYPE_IDR] + [TYPE_P] * (N_P_FRAMES - 1):
        fail(f"frame types {types}, expected IDR then {N_P_FRAMES - 1} P")
    if launches_p != N_P_FRAMES + retries5:
        fail(f"commit launches {launches_p} != {N_P_FRAMES} + {retries5}")
    if deblocks_p < N_P_FRAMES:
        fail(f"deblock launches {deblocks_p} < {N_P_FRAMES} deblocked "
             f"frames")
    for o in outs5:
        shapes = [tuple(np.asarray(r).shape) for r in o.recon]
        if shapes != [(1080, 1920), (540, 960), (540, 960)]:
            fail(f"recon shapes {shapes}")
        if not all(np.isfinite(x) and x > 30.0 for x in o.psnr):
            fail(f"PSNR {o.psnr} (expected finite and > 30 dB)")
    log("phase 5 PSNR Y/U/V per frame: "
        + " ".join(f"{o.psnr[0]:.2f}/{o.psnr[1]:.2f}/{o.psnr[2]:.2f}"
                   for o in outs5))

    # ---- phase 7: the CABAC main path, IDR + 3 P at 1080p ----
    mark("5 IPPP CAVLC path")
    p7 = cabac_params(1920, 1080)
    p7.analyse.psnr = True
    if not (p7.cabac and p7.analyse.trellis == 1):
        fail("the CABAC configuration lost CABAC or trellis 1")
    enc7 = Encoder(p7, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    stream7, outs7 = encode_stream(enc7, clip[:N_CABAC_FRAMES], Picture)
    torch.cuda.synchronize()
    wall7 = time.time() - t0
    launches_c, deblocks_c = launch_counts()
    motion["CABAC"] = motion_counts()
    cavlc["CABAC"] = cavlc_launch().launches
    types7 = [o.i_type for o in outs7]
    retries7 = sum((o.qp - nominal.get(o.i_type, qp_p)) // 4 for o in outs7)
    log(f"phase 7 CABAC main path: {len(outs7)} frames, types {types7}, "
        f"{len(stream7)} bytes, bytes by type "
        f"{enc7.stats['bytes_by_type']}, QPs {[o.qp for o in outs7]}, "
        f"commit launches {launches_c} (= {N_CABAC_FRAMES} frames + "
        f"{retries7} re-encodes), deblock launches {deblocks_c}, P MBs "
        f"{enc7.stats['mb']['P']}, weightp "
        f"frames {enc7.stats.get('weightp_frames', 0)}, motion kernel "
        f"launches {motion['CABAC']}")
    check_motion("phase 7 CABAC main path", motion["CABAC"], SEEDED)
    if types7 != [TYPE_IDR] + [TYPE_P] * (N_CABAC_FRAMES - 1):
        fail(f"CABAC frame types {types7}")
    if launches_c != N_CABAC_FRAMES + retries7:
        fail(f"commit launches {launches_c} != {N_CABAC_FRAMES} + "
             f"{retries7}")
    if deblocks_c < N_CABAC_FRAMES:
        fail(f"deblock launches {deblocks_c} < {N_CABAC_FRAMES} deblocked "
             f"frames")
    if enc7.stats["mb"]["P"]["8x8"] != 0:
        fail("a CABAC frame coded P_8x8 MBs")
    for o in outs7:
        shapes = [tuple(np.asarray(r).shape) for r in o.recon]
        if shapes != [(1080, 1920), (540, 960), (540, 960)]:
            fail(f"recon shapes {shapes}")
        if not all(np.isfinite(x) and x > 30.0 for x in o.psnr):
            fail(f"PSNR {o.psnr} (expected finite and > 30 dB)")
    log("phase 7 PSNR Y/U/V per frame: "
        + " ".join(f"{o.psnr[0]:.2f}/{o.psnr[1]:.2f}/{o.psnr[2]:.2f}"
                   for o in outs7))
    log(f"phase 7 bytes per frame, CABAC: {frame_bytes(stream7)}; CAVLC "
        f"(phase 5, the same frames): "
        f"{frame_bytes(stream5)[:N_CABAC_FRAMES]}")
    key = "phase 7 1080p CABAC frame 0"
    later_cases.append((key, cpu_prefix, (key, cabac_params(1920, 1080),
                                          clip[:1])))
    prefixes[key] = stream7

    # ---- phase 9: 1080p ultrafast, and ultrafast with intra refresh ----
    mark("7 IPPP CABAC path")
    fast = {}
    for label, pir, n, timed in (
            ("ultrafast", False, N_FAST_FRAMES, (3, 4, 5)),
            ("intra refresh", True, N_PIR_FRAMES, (10, 11, 12))):
        fast[label] = fast_path(torch, C, label, ultrafast_params(
            1920, 1080, pir=pir), clip[:n], dev, qp_i, timed)
        motion[label] = fast[label]["motion"]
        cavlc[label] = fast[label]["cavlc"]
        later_cases.append(fast[label]["cpu_case"])
        prefixes[fast[label]["cpu_case"][0]] = fast[label]["stream"]
        mark(f"9 1080p {label} path, its stages")

    # ---- phase 10: the farm, the mesh and the CLI at 1080p ----
    full = full_width_phase(torch, C, dev, clip)
    later_cases.append(full["cli_case"])
    for key in ("farm", "mesh", "cli"):
        motion[key] = full[key]["motion"]
    mark("10 1080p farm, mesh and CLI")

    # ---- phase 6: report ----
    stages = stage_breakdown(torch, enc_big, enc_big._pad_to_mb(clip[0]),
                             qp_i)
    p_stages, stream6, p_prof = p_stage_breakdown(
        torch, p5, clip[:N_P_FRAMES], dev, P_TIMED)
    if stream6 != stream5:
        fail("the timed IPPP encode's stream differs from phase 5's")
    mark("6 I and CAVLC P stage breakdowns")
    c_stages, stream9, c_prof = p_stage_breakdown(
        torch, p7, clip[:N_CABAC_FRAMES], dev, CABAC_TIMED)
    if stream9 != stream7:
        fail("the timed CABAC encode's stream differs from phase 7's")
    mark("6 CABAC P stage breakdown")
    b_stages, b_prof, stream10 = b_stage_breakdown(torch, p8, clip8, dev)
    if stream10 != stream8:
        fail("the timed default-path encode's stream differs from phase 8's")
    mark("6 B stage breakdown and trace")

    # ---- phase 3: CUDA == CPU, in a pool of worker processes, beside the
    # default path's decoder; then the wait for that decoder ----
    results = cuda_cpu_phase("cuda", synth_clip(4, w=640, h=360),
                             first_cases, later_cases)
    for key, stream_k in prefixes.items():
        _, s_cpu, cpu_s = results[key]["prefix"]
        if not stream_k.startswith(s_cpu):
            fail(f"{key}: CUDA stream differs from the CPU port's")
        qp = results[key].get("qp")
        log(f"{key}: CUDA stream == CPU stream ({len(s_cpu)} bytes with the "
            f"headers{'' if qp is None else f', QP {qp}'}; CPU {cpu_s:.1f} "
            f"s in phase 3's pool)")
    mark("3 CUDA vs CPU: streams, CLI, farm, mesh, the paths' first frames")
    decoded8, refdec_s = refdec_finish(refdec8, 1920, 1080, timeout=900)
    if not same_frames(decoded8, [o.recon for o in outs8]):
        fail("refdec does not decode the default path's stream to its "
             "reconstructions")
    log(f"phase 8 refdec decodes the default path's stream ({len(decoded8)} "
        f"frames) to the CUDA reconstructions ({refdec_s:.1f} s since phase "
        f"8, beside the phases after it)")
    mark("8 refdec of the default path, the wait that is left")
    fps = N_FRAMES / wall
    fps5 = N_P_FRAMES / wall5
    fps7 = N_CABAC_FRAMES / wall7
    fps8 = N_DEFAULT_FRAMES / wall8
    log(f"phase 6 fps ({N_FRAMES} x 1080p all-intra, Encoder.encode, host "
        f"clock, first frame included): {fps:.4f} ({wall:.3f} s)")
    log(f"phase 6 fps ({N_P_FRAMES} x 1080p IPPP, Encoder.encode, host "
        f"clock, first frame included): {fps5:.4f} ({wall5:.3f} s)")
    log(f"phase 6 fps ({N_CABAC_FRAMES} x 1080p IPPP CABAC, Encoder.encode, "
        f"host clock, first frame included): {fps7:.4f} ({wall7:.3f} s)")
    log(f"phase 6 fps ({N_DEFAULT_FRAMES} x 1080p defaults with B frames, "
        f"Encoder.encode, host clock, lookahead and first frame included): "
        f"{fps8:.4f} ({wall8:.3f} s)")
    log("phase 6 stages ms per 1080p I frame (host clock, synchronised): "
        + json.dumps(stages))
    log("phase 6 stages ms per 1080p P frame, two references (host clock, "
        "synchronised; the Encoder.encode call that dispatches P frame 2 "
        "and finalizes 1; its stream == phase 5's): "
        + json.dumps(p_stages))
    log("phase 6 stages ms per 1080p CABAC P frame, two references (host "
        "clock, synchronised; the Encoder.encode call that dispatches P "
        "frame 2 and finalizes 1; its stream == phase 7's): "
        + json.dumps(c_stages))
    log("phase 6 stages ms per 1080p B frame of the default path (host "
        "clock, synchronised, over every B frame of the clip; the lookahead "
        "stages are sums over the clip's one decision; its stream == phase "
        "8's): " + json.dumps(b_stages))
    for label, prof, phase in (("CAVLC", p_prof, 5), ("CABAC", c_prof, 7)):
        log(f"phase 6 1080p {label} P frame under torch.profiler (the "
            f"encode call that dispatches the clip's last P frame, two "
            f"references, and finalizes the one before; its stream == "
            f"phase {phase}'s): " + profile_text(prof))
    log("phase 6 1080p B frame under torch.profiler (the encode call that "
        "dispatches the clip's last B frame and finalizes an earlier "
        "frame): " + profile_text(b_prof))
    for label, r in fast.items():
        log(f"phase 6 fps ({r['frames']} x 1080p {label}, Encoder.encode, "
            f"host clock, first frame included): {r['fps']:.4f} "
            f"({r['wall']:.3f} s)")
        log(f"phase 6 stages ms per 1080p P frame, {label} (host clock, "
            f"synchronised; the Encoder.encode calls {r['timed']}, each "
            f"dispatching the P frame before it; its stream == phase 9's): "
            + json.dumps(r["stages"]))
        log(f"phase 6 1080p P frame, {label}, under torch.profiler (the "
            f"encode call that dispatches the clip's last P frame and "
            f"finalizes the one before; its stream == phase 9's): "
            + profile_text(r["profile"]))
    log("phase 6 motion kernel launches per path (counts from 0 just "
        "before each path, read just after): " + json.dumps(motion))
    log("phase 6 cavlc_residual_kernel launches per path (counts from 0 "
        "just before each path, read just after): " + json.dumps(cavlc))
    log("phase 6 host seconds by phase: " + json.dumps(phase_seconds()))
    check_clean_imports()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    kernels = [{
        "name": "commit_frame_kernel", "route": "cuda",
        "source": "x264_tpu_torch/csrc/commit.cu",
        "replaces": "x264_tpu/ops/pallas/commit.py:672",
        "launches": launches_p, "max_abs_err": worst,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "earlier_ms": e_ms,
        "launches_all_intra_path": launches,
        "launches_cabac_path": launches_c,
        "launches_default_path": launches_d,
        "launches_ultrafast_path": fast["ultrafast"]["launches"],
        "launches_intra_refresh_path": fast["intra refresh"]["launches"],
        "mixed_p_frame_ms": real_p["mixed+i4"]["ms"],
        "mixed_p_frame_plain_ms": real_p["mixed+i4"]["plain_ms"],
        "mixed_p_frame_bound_ms": real_p["mixed+i4"]["bound_ms"],
        "mixed_p_frame_bound_by": real_p["mixed+i4"]["bound_by"],
        "mixed_no_i4_ultrafast_p_frame_ms": real_p["mixed"]["ms"],
        "mixed_no_i4_ultrafast_p_frame_plain_ms":
        real_p["mixed"]["plain_ms"],
        "mixed_no_i4_ultrafast_p_frame_bound_ms":
        real_p["mixed"]["bound_ms"],
        "mixed_no_i4_ultrafast_p_frame_bound_by":
        real_p["mixed"]["bound_by"]}, {
        "name": "commit_frame_kernel, batched (B items per launch)",
        "route": "cuda", "source": "x264_tpu_torch/csrc/commit.cu",
        "replaces": "x264_tpu/ops/pallas/commit.py:672",
        "launches": full["launches"], "max_abs_err": batched["worst"],
        "ms": batched["band_ms"], "plain_ms": batched["band_plain_ms"],
        "bound_ms": batched["band_bound_ms"],
        "bound_by": batched["band_bound_by"], "library_ms": None,
        "shape": "the mesh's I step on one 1080p frame: 4 bands of 17 MB "
                 "rows in one launch",
        "launches_farm_1080p": full["farm"]["launches"]["commit"],
        "launches_mesh_1080p": full["mesh"]["launches"]["commit"],
        "launches_cli_1080p": full["cli"]["launches"],
        "s_1080p_frames": {str(S): {
            "batched_ms": sum(t["batched_ms"]) / 2,
            "singles_ms": sum(t["singles_ms"]) / 2,
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}
            for S, t in batched["timing"].items()}}, {
        "name": "deblock_frame_kernel", "route": "cuda",
        "source": "x264_tpu_torch/csrc/deblock.cu",
        "replaces": "x264_tpu/ops/deblock.py:263 (jnp lax.scan)",
        "launches": deblocks_p, "max_abs_err": dbk["worst"],
        "ms": dbk["p"]["ms"], "earlier_ms": dbk["p"]["earlier_ms"],
        "plain_ms": dbk["p"]["plain_ms"],
        "bound_ms": dbk["p"]["bound_ms"], "bound_by": dbk["p"]["bound_by"],
        "library_ms": None,
        "shape": "P frame 1 of the 1080p clip at preset medium "
                 "(compute_strengths, two references)",
        "i_frame_ms": dbk["i"]["ms"],
        "i_frame_earlier_ms": dbk["i"]["earlier_ms"],
        "i_frame_plain_ms": dbk["i"]["plain_ms"],
        "i_frame_bound_ms": dbk["i"]["bound_ms"],
        "i_frame_bound_by": dbk["i"]["bound_by"],
        "chain_steps": dbk["chain_steps"],
        "earlier_chain_steps": dbk["earlier_chain_steps"],
        "us_per_chain_step": dbk["p"]["us_per_chain_step"],
        "earlier_us_per_chain_step": dbk["p"]["earlier_us_per_chain_step"],
        "mb_rows_per_block": dbk["rows"],
        "rows_tried_ms": {"p": dbk["p"]["rows_ms"], "i": dbk["i"]["rows_ms"]},
        "co_resident_blocks": dbk["capacity"],
        "launches_all_intra_path": deblocks,
        "launches_cabac_path": deblocks_c,
        "launches_default_path": deblocks_d,
        "launches_ultrafast_path": fast["ultrafast"]["deblocks"],
        "launches_intra_refresh_path": fast["intra refresh"]["deblocks"],
        "launches_farm_1080p": full["farm"]["launches"]["deblock"],
        "launches_mesh_1080p": full["mesh"]["launches"]["deblock"],
        "launches_cli_1080p": full["cli"]["deblocks"]}] + [{
        "name": name, "route": "cuda",
        "source": "x264_tpu_torch/csrc/motion.cu", "replaces": replaces,
        # me_esa runs on the default path (B frames) and the mesh, the
        # others on the P main path
        "launches": motion["defaults" if name == "me_esa" else "IPPP"][name],
        "max_abs_err": mot["worst"][name], "ms": mot[name]["ms"],
        "plain_ms": mot[name]["plain_ms"], "bound_ms": mot[name]["bound_ms"],
        "bound_by": mot[name]["bound_by"], "library_ms": None,
        "bound_share": mot[name]["bound_ms"] / mot[name]["ms"],
        **{k: mot["ptxas"][name][k] for k in ("registers", "smem_bytes",
                                              "spill_bytes")},
        "shape": mot[name]["shape"],
        "launches_per_path": {k: v[name] for k, v in motion.items()},
        **({"lanes_ms": {str(n): {"ms": sum(t["ms"]) / 2,
                                  "bound_ms": t["bound_ms"]}
                         for n, t in mot["lanes"].items()},
            "pairs_reused": mot["pairs_reused"]}
           if name == "me_subpel" else {})}
        for name, _, replaces in MOTION_KERNELS] + [{
        "name": "cavlc_residual_kernel", "route": "cuda",
        "source": "x264_tpu_torch/csrc/cavlc.cu",
        "replaces": "x264_tpu/entropy/cavlc_jax.py:82 (residual_blocks_dev, "
                    "XLA's fusion; no Pallas kernel)",
        "launches": cavlc["IPPP"], "max_abs_err": cav["worst"],
        "ms": cav["calls"][0]["ms"], "plain_ms": cav["calls"][0]["plain_ms"],
        "bound_ms": cav["calls"][0]["bound_ms"],
        "bound_by": cav["calls"][0]["bound_by"], "library_ms": None,
        "bound_share": cav["calls"][0]["bound_share"],
        **{k: cav["ptxas"][k] for k in ("registers", "smem_bytes",
                                        "spill_bytes")},
        "shape": cav["calls"][0]["label"],
        "calls": [{k: c[k] for k in ("label", "ms", "plain_ms", "bound_ms",
                                     "bound_share")} for c in cav["calls"]],
        "launches_per_path": cavlc}]
    over = [k["name"] for k in kernels if k["bound_ms"] > k["ms"]]
    if over:
        fail(f"bound above the measured time (the count is no lower "
             f"bound): {over}")
    log(json.dumps({"kernels": kernels}))
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def fast_path(torch, C, label, params, clip, dev, qp_i, timed_calls):
    """Phase 9: one 1080p path at preset ultrafast through Encoder.encode
    on the card, the commit launches counted per dispatched frame (reset
    just before, read just after), then the P-frame stage breakdown while
    the clip is encoded again (its stream must equal this one's):
    `timed_calls` are the encode calls timed. Frames 0-1 against a CPU
    encode of the same two frames is a case of phase 3 ("cpu_case").
    Under intra refresh each frame's refresh band (first and last column,
    empty while no sweep runs) is kept; the sweep starts at frame keyint,
    where the keyframe becomes a P frame and a recovery point. Returns
    what the report reads."""
    import numpy as np
    from x264_tpu_torch.encoder.encoder import (TYPE_IDR, TYPE_P, Encoder,
                                                Picture)
    params.analyse.psnr = True
    enc = Encoder(params, device=dev)
    per_frame, bands = [], []
    enqueue_real, pir_real = enc._enqueue_frame, enc._pir_advance

    def counted(*a, **kw):
        n0 = C.commit.launches
        out = enqueue_real(*a, **kw)
        per_frame.append(C.commit.launches - n0)
        return out

    def banded(ftype, idx):
        out = pir_real(ftype, idx)
        bands.append(None if out[1] is None else
                     {"frame": idx, "columns": list(out[1][:2]),
                      "recovery": out[2]})
        return out

    enc._enqueue_frame = counted
    enc._pir_advance = banded
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    stream, outs = encode_stream(enc, clip, Picture)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, deblocks = launch_counts()
    motion = motion_counts()
    cavlc = cavlc_launch().launches
    types = [o.i_type for o in outs]
    n = len(clip)
    retries = sum((o.qp - qp_i) // 4 if o.i_type == TYPE_IDR else
                  (o.qp - params.rc.qp_constant) // 4 for o in outs)
    log(f"phase 9 1080p {label}: {len(outs)} frames, types {types}, "
        f"{len(stream)} bytes, bytes per frame {frame_bytes(stream)}, QPs "
        f"{[o.qp for o in outs]}, keyframes {[o.b_keyframe for o in outs]}, "
        f"commit launches {launches} (per dispatched frame {per_frame}; "
        f"{n} frames + {retries} re-encodes), deblock launches {deblocks} "
        f"(ultrafast: no deblock), P MBs {enc.stats['mb']['P']}, motion "
        f"kernel launches {motion}")
    check_motion(f"phase 9 1080p {label}", motion, SEEDED)
    if types != [TYPE_IDR] + [TYPE_P] * (n - 1):
        fail(f"{label}: frame types {types}")
    if launches != n + retries:
        fail(f"{label}: commit launches {launches} != {n} + {retries}")
    if params.deblocking_filter or deblocks != 0:
        fail(f"{label}: {deblocks} deblock launches, deblock "
             f"{params.deblocking_filter}: ultrafast must not deblock")
    if params.intra_refresh:
        swept = [[b["frame"], *b["columns"], b["recovery"]] for b in bands
                 if b and b["columns"][0] <= b["columns"][1]]
        log(f"phase 9 1080p {label}: refresh band [frame, first column, "
            f"last column, recovery point] where a sweep runs: "
            f"{json.dumps(swept)}")
        k = params.keyint_max
        sweep = bands[k:2 * k]
        if not (outs[k].b_keyframe and sweep[0]["recovery"]
                and sweep[0]["columns"][0] == 0
                and sweep[-1]["columns"][1] == params.width // 16 - 1):
            fail(f"{label}: no sweep from column 0 to the last, starting "
                 f"with a recovery point, in frames {k}-{2 * k - 1}")
    w, h = params.width, params.height
    for o in outs:
        shapes = [tuple(np.asarray(r).shape) for r in o.recon]
        if shapes != [(h, w), (h // 2, w // 2), (h // 2, w // 2)]:
            fail(f"recon shapes {shapes}")
        if not all(np.isfinite(x) and x > 30.0 for x in o.psnr):
            fail(f"{label}: PSNR {o.psnr} (expected finite and > 30 dB)")
    log(f"phase 9 1080p {label} PSNR Y/U/V per frame: "
        + " ".join(f"{o.psnr[0]:.2f}/{o.psnr[1]:.2f}/{o.psnr[2]:.2f}"
                   for o in outs))
    stages, stream2, prof = p_stage_breakdown(torch, params, clip, dev,
                                              timed_calls)
    if stream2 != stream:
        fail(f"the timed {label} encode's stream differs from phase 9's")
    # frames 0-1 against the CPU port's: a case of phase 3
    key = f"phase 9 1080p {label} frames 0-1"
    return {"fps": n / wall, "wall": wall, "launches": launches,
            "deblocks": deblocks, "motion": motion, "cavlc": cavlc,
            "stages": stages, "profile": prof, "frames": n,
            "timed": list(timed_calls),
            "stream": stream,
            "cpu_case": (key, cpu_prefix, (key, params.copy(), clip[:2]))}


def stage_breakdown(torch, enc, planes, qp):
    """Host-clock time of each stage of one 1080p I frame (synchronised
    after each stage; mean of 2 runs after one warm-up)."""
    from x264_tpu_torch.encoder import intra
    from x264_tpu_torch.encoder.frame_encode import build_qp_maps
    from x264_tpu_torch.encoder.lookahead import intra_blocks, lowres_plane
    from x264_tpu_torch.entropy.cavlc_dev import encode_i16x16_frame_dev
    from x264_tpu_torch.ops import mc
    from x264_tpu_torch.ops.commit import commit
    from x264_tpu_torch.ops.deblock import deblock_frame, intra_strengths
    y, u, v = planes
    mbw, mbh = enc.mb_w, enc.mb_h
    cap_words = mbw * mbh * intra.cap_bytes_per_mb(qp) // 4
    acc = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(3):
        timed("lookahead", lambda: intra_blocks(lowres_plane(y)[0]))
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp)
        lam = intra.mb_lambda(qp_mb)
        m, cm, _, c16 = timed("decide_i16", lambda: intra.decide_modes_full(
            y, u, v, lam=lam))
        m4, c4 = timed("decide_i4", lambda: intra.decide_modes_i4(y,
                                                                  lam=lam))
        co, rec = timed("commit_kernel", lambda: commit(
            y, u, v, m, cm, qp_mb, qpc_mb, mbw, mbh, i4_mask=c4 < c16,
            i4_modes=m4))
        words, bits, eff = timed("cavlc", lambda: encode_i16x16_frame_dev(
            m.reshape(-1), cm.reshape(-1), qp_mb.reshape(-1), qp, co["dc"],
            co["ac"], torch.stack([co["udc"], co["vdc"]], 1),
            torch.stack([co["uac"], co["vac"]], 1), mbw=mbw, mbh=mbh,
            cap_words=cap_words, is_i4=(c4 < c16).reshape(-1),
            i4_modes=m4.reshape(-1, 16)))
        bs = intra_strengths(mbw, mbh, y.device)
        rec = timed("deblock", lambda: deblock_frame(
            *rec, *bs, eff.reshape(mbh, mbw), mbw=mbw, mbh=mbh))
        timed("dpb_push", lambda: mc.hpel_planes(mc.pad_plane(rec[0])))
        timed("payload_to_host", lambda: words[:(int(bits) + 31) // 32]
              .cpu().numpy())
    return {k: round(sum(v[1:]) / len(v[1:]), 3) for k, v in acc.items()}


def enqueue(enc, frame, ftype, idx):
    """Dispatch one frame of `enc` as Encoder.encode would once the
    lookahead decided it (QP, DPB push, source luma kept for weightp)."""
    from x264_tpu_torch.encoder.encoder import Picture
    enc._enqueue_frame(enc._pad_to_mb(frame), ftype, Picture(frame, pts=idx),
                       idx)
    enc._pipe.clear()


def captured_commit(enc, frame, idx, deblock_calls=None):
    """Dispatch `frame` as P frame `idx` of `enc` (the encoder's own
    dispatch, as enqueue) and return the (args, kwargs) of the commit
    that its P pipeline called. With a list `deblock_calls`, the P
    pipeline's deblock call lands there too (capture_calls)."""
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.encoder.encoder import TYPE_P
    real, calls = inter.commit, []

    def keep(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    inter.commit = keep
    restore = (capture_calls(inter, "deblock_frame", deblock_calls)
               if deblock_calls is not None else (lambda: None))
    try:
        enqueue(enc, frame, TYPE_P, idx)
    finally:
        inter.commit = real
        restore()
    if len(calls) != 1:
        fail(f"P frame {idx} made {len(calls)} commit calls, expected 1")
    return calls[0]


class StageTimer:
    """Times the stages of a path while Encoder.encode runs it. Each
    stage function in `hooks` (module, attribute, stage name) is a module
    attribute that the pipeline looks up when it calls it (and the
    encoder's DPB push a method of `enc`):
    inside the `with` block each is wrapped so that every call is
    synchronised before and after, and its host-clock time less that of
    the stages it calls (the commit inside the merge) goes to its stage.
    With `ranges`, every call also runs in a torch.profiler range
    "stage:<name>". `extra` adds (object, attribute, stage) hooks."""

    P_HOOKS = (("lookahead", "_search_pair", "lookahead_search"),
             ("inter", "p_fullpel_core", "fullpel"),
             ("inter", "p_subpel_core", "subpel"),
             ("inter", "p_me_select", "subpel"),
             ("inter", "p_intra_core", "intra"),
             ("inter", "p_rd_core", "rd"),
             ("inter", "p_xfrm_core", "xfrm"),
             ("inter", "commit", "commit_kernel"),
             ("inter", "p_merge_core", "merge_cbp_skip"),
             ("inter", "encode_pframe_entropy_dev", "cavlc"),
             ("inter", "p_deblock_core", "deblock"),
             ("inter", "finalize_slice", "finalize_slice"),
             # CABAC frames only: the trellis inside xfrm, the decision
             # packing, and the host tail split into the device-to-host
             # copy, the C++ writer and the rest (reorder, header, NAL)
             ("inter", "trellis_4x4", "trellis"),
             ("inter", "p_decisions_core", "decisions"),
             ("inter", "decisions_to_host", "decisions_to_host"),
             ("inter", "encode_slice_cabac", "cabac_writer"),
             ("inter", "cabac_finalize_pframe", "cabac_finalize"))
    # a B frame's stages (encoder/bframe.py), and the lookahead's, which
    # with MB-tree decides the whole clip in one call
    B_HOOKS = (("bframe", "dispatch_bframe", "b_dispatch_rest"),
               ("bframe", "motion_search", "esa"),
               ("bframe", "subpel_refine_mc", "subpel"),
               ("bframe", "b_direct_core", "direct"),
               ("bframe", "b_luma_core", "luma_xfrm"),
               ("bframe", "trellis_4x4", "trellis"),
               ("bframe", "b_chroma_core", "chroma"),
               ("bframe", "b_decisions_core", "decisions"),
               ("bframe", "b_deblock_core", "deblock"),
               ("bframe", "decisions_to_host", "decisions_to_host"),
               ("bframe", "encode_slice_cabac", "cabac_writer"),
               ("bframe", "cabac_finalize_bframe", "cabac_finalize"),
               ("lookahead", "_search_pair", "lookahead_search"),
               ("lookahead", "_bidir_cost", "lookahead_bidir"),
               ("lookahead", "_mbtree_propagate", "mbtree_propagate"),
               ("lookahead", "_mbtree_finish", "mbtree_finish"))

    def __init__(self, torch, enc, ranges=False, hooks=P_HOOKS,
                 dpb_push=True, extra=()):
        from x264_tpu_torch.encoder import (bframe, farm, inter, intra,
                                            lookahead)
        from x264_tpu_torch.parallel import mesh
        mods = {"inter": inter, "lookahead": lookahead, "bframe": bframe,
                "intra": intra, "farm": farm, "mesh": mesh}
        self.torch, self.ranges = torch, ranges
        self.ms, self.calls, self._inner = {}, {}, []
        self._hooks = [(mods[m], attr, stage) for m, attr, stage in hooks]
        if dpb_push:
            self._hooks.append((enc, "_dpb_push_entry", "dpb_push"))
        self._hooks += list(extra)

    def _wrap(self, fn, stage):
        import contextlib
        from torch.profiler import record_function
        sync = self.torch.cuda.synchronize

        def timed(*args, **kw):
            sync()
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                with (record_function("stage:" + stage) if self.ranges
                      else contextlib.nullcontext()):
                    out = fn(*args, **kw)
                    sync()
            finally:
                inner = self._inner.pop()
            dt = (time.perf_counter() - t0) * 1e3
            self.ms[stage] = self.ms.get(stage, 0.0) + dt - inner
            self.calls[stage] = self.calls.get(stage, 0) + 1
            if self._inner:
                self._inner[-1] += dt
            return out
        return timed

    def __enter__(self):
        # an attribute not in the object's own dict (the encoder's
        # method) is deleted again on exit, the others are put back
        self._saved = [(obj, attr, vars(obj).get(attr))
                       for obj, attr, _ in self._hooks]
        for obj, attr, stage in self._hooks:
            setattr(obj, attr, self._wrap(getattr(obj, attr), stage))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self._saved:
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        return False


P_TIMED = (3,)          # the encode call of clip frame 3: P 2 dispatched
CABAC_TIMED = (3,)      # of the 4-frame CABAC clip: P 2 dispatched


def frame_bytes(stream):
    """Bytes of each coded picture (slice NALs, start codes included) of
    an Annex-B stream: what follows each start code whose NAL type is 1
    or 5, up to the next start code."""
    cuts = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        cuts.append(i)
        i = stream.find(b"\x00\x00\x01", i + 3)
    cuts.append(len(stream))
    return [b - a for a, b in zip(cuts, cuts[1:])
            if (stream[a + 3] & 31) in (1, 5)]


def p_stage_breakdown(torch, params, clip, dev, timed_calls):
    """Stages of the P path as Encoder.encode runs them, per P frame with
    two references: a fresh encoder takes the IPPP clip; the calls that
    take the frames `timed_calls` (each dispatches the P frame before it,
    which searches two references, and finalizes the one before that) run
    under a StageTimer. The first flush call (it dispatches the clip's
    last P frame, two references, and finalizes the one before) runs under
    torch.profiler (device_profile). Returns (ms per frame by stage, the
    whole stream, the profile)."""
    from x264_tpu_torch.encoder.encoder import Encoder, Picture, annexb_bytes
    enc = Encoder(params, device=dev)
    stream = annexb_bytes(enc.headers())
    timer = StageTimer(torch, enc)
    wall = 0.0
    prof = None
    for i, frame in enumerate(list(clip) + [None]):
        while True:
            pic = None if frame is None else Picture(frame, pts=i)
            if frame is None and prof is None:
                prof, nals, out = device_profile(torch, enc,
                                                 StageTimer.P_HOOKS)
            elif i in timed_calls:
                with timer:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    nals, out = enc.encode(pic)
                    torch.cuda.synchronize()
                    wall += (time.perf_counter() - t0) * 1e3
            else:
                nals, out = enc.encode(pic)
            stream += annexb_bytes(nals)
            if frame is not None or out is None:
                break
    runs = len(timed_calls)
    stages = {k: round(v / runs, 3) for k, v in timer.ms.items()}
    stages["unstaged"] = round((wall - sum(timer.ms.values())) / runs, 3)
    stages["encode_call"] = round(wall / runs, 3)
    stages["calls"] = timer.calls
    return stages, stream, prof


def b_stage_breakdown(torch, params, clip, dev):
    """Stages of a B frame of the default path as Encoder.encode runs
    them: a fresh encoder takes the clip (nothing is decided before the
    flush: the MB-tree window is deeper than the clip); every flush call
    runs under a StageTimer that wraps the B path's stage functions and
    the lookahead's, so P and I frames pass untimed, and `dispatch_bframe`
    itself is wrapped too (its synchronise drains what the frames before
    left on the card; its own time is what a B dispatch does outside the
    stages: QP maps with AQ, co-located fields, cbp and skip). The flush
    call that dispatches the clip's last B frame runs under torch.profiler
    (device_profile) and stays out of the host-clock means. Returns (ms per
    B frame by stage, with the lookahead's stages as sums over the clip;
    the profile; the stream)."""
    from x264_tpu_torch.encoder.encoder import (TYPE_B, Encoder, Picture,
                                                annexb_bytes)
    enc = Encoder(params, device=dev)
    stream = annexb_bytes(enc.headers())
    for i, frame in enumerate(clip):
        nals, out = enc.encode(Picture(frame, pts=i))
        if nals or out is not None:
            fail("the default path gave a picture before the flush")
    timer = StageTimer(torch, enc, hooks=StageTimer.B_HOOKS, dpb_push=False)
    prof = None
    while True:
        b_left = sum(ftype == TYPE_B for _, ftype, _, _ in enc._ready)
        if b_left == 1 and enc._ready[0][1] == TYPE_B:
            prof, nals, out = device_profile(
                torch, enc, StageTimer.B_HOOKS, dpb_push=False)
        else:
            with timer:
                nals, out = enc.encode(None)
        stream += annexb_bytes(nals)
        if out is None:
            break
    # the profiled frame's host times are the profiler's, not the path's:
    # the means are over the other B frames (a clip with one B frame has
    # nothing else to show)
    timed_b = enc.stats["count"]["B"] - 1
    per_clip = ("lookahead_search", "lookahead_bidir", "mbtree_propagate",
                "mbtree_finish")
    # a stage's mean per call, times its calls per frame (one search and
    # one refine per list); a B frame is finalized two calls after its
    # dispatch, so the host tail's stages count one frame more than the
    # dispatch's stages do
    per_frame = {"esa": 2, "subpel": 2}
    if timed_b == 0:
        timer.ms = dict(prof["stage_host_ms"])
        timer.calls = {k: per_frame.get(k, 1) for k in timer.ms}
    stages = {k: round(v if k in per_clip else
                       v / timer.calls.get(k, 1) * per_frame.get(k, 1), 3)
              for k, v in timer.ms.items()}
    stages["b_frame_stage_sum"] = round(sum(
        v for k, v in stages.items() if k not in per_clip), 3)
    stages["b_frames_timed"] = max(timed_b, 1)
    stages["calls"] = timer.calls
    return stages, prof, stream


def profile_text(prof):
    """A device_profile result as the report prints it."""
    return json.dumps(prof) + ("" if prof["device_ops"] else " (the "
                               "profiler saw no device time: device idle "
                               "share not measured)")


def trace_events(torch, prof):
    """(name, on the card, start us, duration us) of every event of a
    finished torch.profiler trace. Read from the profiler's raw event
    list where this PyTorch has it: building `prof.events()` for the
    ~1,000,000 events of one 1080p frame takes minutes, reading four
    fields of each takes seconds. Both give the same events."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        raw = raw.events()
        if raw and hasattr(raw[0], "start_ns") \
                and hasattr(raw[0], "duration_ns"):
            return [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
                     e.duration_ns() / 1e3) for e in raw]
    return [(e.name, e.device_type == cuda, e.time_range.start,
             e.time_range.elapsed_us()) for e in prof.events()]


def device_profile(torch, enc, hooks, dpb_push=True):
    """One flush call of `enc`, encode(None) (it dispatches one frame and
    finalizes an earlier one: one frame's work) under torch.profiler,
    each stage of `hooks` in its range and synchronised as StageTimer
    does: per stage the card's time and operation count (kernels, copies
    and sets whose start lies in the stage's innermost range) and the
    host-clock time, and the device idle share (1 - the card's busy time
    over the call's host-clock time). Returns (that, with every number
    None when the profiler saw no operation on the card; the call's NALs
    and picture)."""
    from torch.profiler import ProfilerActivity, profile
    timer = StageTimer(torch, enc, ranges=True, hooks=hooks,
                       dpb_push=dpb_push)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, timer:
        t0 = time.perf_counter()
        nals, out = enc.encode(None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    host = {k: round(v, 3) for k, v in timer.ms.items()}
    events = trace_events(torch, prof)
    ops = [e for e in events if e[1] and not e[0].startswith("stage:")]
    windows = [(name[len("stage:"):], start, start + dur)
               for name, on_card, start, dur in events
               if not on_card and name.startswith("stage:")]
    if not ops:
        return {"frame_host_ms": round(wall_ms, 3), "device_busy_ms": None,
                "device_idle_share": None, "device_ops": 0,
                "stage_host_ms": host}, nals, out
    stages, counts = {}, {}
    for _, _, start, dur in ops:
        hits = [w for w in windows if w[1] <= start <= w[2]]
        key = max(hits, key=lambda w: w[1])[0] if hits else "unstaged"
        stages[key] = stages.get(key, 0.0) + dur / 1e3
        counts[key] = counts.get(key, 0) + 1
    busy_ms = sum(e[3] for e in ops) / 1e3
    return {"frame_host_ms": round(wall_ms, 3),
            "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "device_ops": len(ops),
            "stage_device_ms": {k: round(v, 3) for k, v in stages.items()},
            "stage_device_ops": counts,
            "stage_host_ms": host}, nals, out


AB_VARIANTS = ("i16+i4", "mixed+i4", "mixed")


def commit_ab_child(tree):
    """One side of --commit-ab: build the commit kernel of the checkout at
    `tree` and time its single-frame launch (B = 1) on the 1080p inputs of
    phase 2: the I frame's commit (i16+i4, seeded as phase 2 seeds it) and
    the commits of the encoder's own P frame 1 at preset medium (mixed+i4)
    and at ultrafast (mixed). 3 warm-up launches, then 2 x 20 launches
    (CUDA events). Prints one JSON line: each variant's times and a digest
    of its outputs."""
    import hashlib
    import torch
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import x264_tpu_torch
    if not os.path.abspath(x264_tpu_torch.__file__).startswith(tree + os.sep):
        fail(f"--commit-ab: imported {x264_tpu_torch.__file__}, not {tree}")
    from bench import synth_clip
    from x264_tpu_torch.encoder.encoder import TYPE_IDR, Encoder
    from x264_tpu_torch.ops import commit as C
    dev = torch.device("cuda")
    C.build_library()
    C._library()
    clip = synth_clip(2)
    enc = Encoder(intra_params(1920, 1080), device=dev)
    qp_i = enc.rc.start(TYPE_IDR, -1, frame_idx=0)
    cases = {"i16+i4": commit_inputs(torch, enc, enc._pad_to_mb(clip[0]),
                                     qp_i, seed=7, mixed=False, with_i4=True)}
    for variant, make in (("mixed+i4", ippp_params),
                          ("mixed", ultrafast_params)):
        enc_p = Encoder(make(1920, 1080), device=dev)
        enqueue(enc_p, clip[0], TYPE_IDR, 0)
        cases[variant] = captured_commit(enc_p, clip[1], 1)
    out = {}
    for variant in AB_VARIANTS:
        args, kw = cases[variant]
        progs = []

        def run():
            progs.append(C.commit_launch(*args, **kw)[2])

        cuda_ms(torch, run, 3)
        runs = [cuda_ms(torch, run, 20) for _ in range(2)]
        for prog in progs:
            C.check_progress(prog, args[7])
        got = C.commit_cuda(*args, **kw)
        digest = hashlib.sha256()
        for t in list(got[0].values()) + list(got[1]):
            digest.update(t.cpu().numpy().tobytes())
        out[variant] = {"ms": runs, "digest": digest.hexdigest()[:16]}
    print(json.dumps({"tree": tree, "variants": out}), flush=True)


MOTION_AB_VARIANTS = ("me_lowres_scan", "me_refine", "me_esa",
                      "me_subpel")


def motion_ab_child(tree):
    """One side of --motion-ab: build the motion kernels of the checkout
    at `tree` and time each on the 1080p inputs of phase 2's P frame 2,
    reference 0 (preset medium): the seeded search's two launches, the
    9-lane qpel refine, and the ESA's second pass at me_range 16 (16x16
    lane). 3 warm-up launches, then 2 x 20 launches (CUDA events, queued
    behind a torch.cuda._sleep). Prints one JSON line: each kernel's times
    and a digest of its outputs."""
    import hashlib
    import torch
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import x264_tpu_torch
    if not os.path.abspath(x264_tpu_torch.__file__).startswith(tree + os.sep):
        fail(f"--motion-ab: imported {x264_tpu_torch.__file__}, not {tree}")
    from bench import synth_clip
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.encoder.encoder import TYPE_IDR, TYPE_P, Encoder
    from x264_tpu_torch.ops import motion as MO
    dev = torch.device("cuda")
    MO._library()
    clip = synth_clip(3)
    enc = Encoder(ippp_params(1920, 1080), device=dev)
    enqueue(enc, clip[0], TYPE_IDR, 0)
    enqueue(enc, clip[1], TYPE_P, 1)
    seeded, subpel = [], []
    restore = [capture_calls(inter, "motion_search_seeded", seeded, 1),
               capture_calls(inter, "subpel_refine_all", subpel, 1)]
    enqueue(enc, clip[2], TYPE_P, 2)
    for r in restore:
        r()
    (sa, skw), (qa, qkw) = seeded[0], subpel[0]
    parts = motion_parts("seeded", sa, skw)[0]
    yp, y, lam = sa[:3]
    mv1 = MO.fullpel_plain(yp, y, None, None, lam, 16, False)
    mvp = inter.mv_predictors(mv1 * 4)[0].contiguous()
    launches = {name: (launch, a) for name, launch, _, a in parts}
    launches["me_esa"] = (MO.esa_launch, (yp, y, mvp, lam, 16, False))
    _, launch, _, a = motion_parts("subpel_all", qa, qkw)[0][0]
    launches["me_subpel"] = (launch, a)
    out = {}
    for name in MOTION_AB_VARIANTS:
        launch, a = launches[name]
        cuda_ms(torch, lambda: launch(*a), 3)
        runs = [cuda_ms(torch, lambda: launch(*a), 20, prefill=True)
                for _ in range(2)]
        digest = hashlib.sha256()
        got = launch(*a)
        for t in (got.values() if isinstance(got, dict) else
                  got if isinstance(got, tuple) else [got]):
            digest.update(t.cpu().numpy().tobytes())
        out[name] = {"ms": runs, "digest": digest.hexdigest()[:16]}
    print(json.dumps({"tree": tree, "variants": out}), flush=True)


def ab(kind, other):
    """--commit-ab / --motion-ab OTHER: the commit kernel's single-frame
    launch (commit_ab_child), or the motion kernels (motion_ab_child), of
    the checkout at OTHER (for example the parent commit, unpacked with
    git archive into a directory that .gitignore lists) against this
    one's, on one card, each in a process of its own in the order other,
    this, this, other. Fails unless every run's outputs are the same.
    Prints each run, each variant's mean times and change, and the card's
    name and power limit."""
    variants = {"commit": AB_VARIANTS, "motion": MOTION_AB_VARIANTS}[kind]
    runs = []
    for tree in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            f"--{kind}-ab-child", tree], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            fail(f"--{kind}-ab run in {tree} exited {r.returncode}:\n"
                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        log(f"{kind}_ab {'other' if tree == other else 'this'}: "
            + json.dumps(runs[-1]))
    summary = {}
    for variant in variants:
        if len({run["variants"][variant]["digest"] for run in runs}) != 1:
            fail(f"--{kind}-ab: the {variant} outputs differ between runs")
        ms = {side: [t for run in pair for t in run["variants"][variant]["ms"]]
              for side, pair in (("other", (runs[0], runs[3])),
                                 ("this", (runs[1], runs[2])))}
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        summary[variant] = {"other_ms": ms["other"], "this_ms": ms["this"],
                            "change": mean["this"] / mean["other"] - 1}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    log(smi.stdout.strip())
    log(json.dumps({f"{kind}_ab": summary}))


if __name__ == "__main__":
    if sys.argv[1:2] in (["--commit-ab"], ["--motion-ab"]):
        ab("commit" if sys.argv[1] == "--commit-ab" else "motion",
           os.path.abspath(sys.argv[2]))
    elif sys.argv[1:2] == ["--commit-ab-child"]:
        commit_ab_child(sys.argv[2])
    elif sys.argv[1:2] == ["--motion-ab-child"]:
        motion_ab_child(sys.argv[2])
    elif sys.argv[1:2] == ["--cavlc"]:
        cavlc_only()
    else:
        main()
