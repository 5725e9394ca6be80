"""The port's wavefront commit, mode decisions and device CAVLC against
their JAX twins.

commit_ref (x264_tpu_torch/ops/commit.py) is held against
intra._commit_scan and against the Pallas kernel commit_i16_pallas run in
interpret mode, in the 5 cases of tests/test_pallas_commit.py, in the
default diagonal order and in the frame kernel's raster MB order. Exact
equality throughout (integer outputs, tolerance 0). The CUDA kernel is
held against commit_ref by the `cuda`-marked tests, which run only where
a card is present (and in chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x264_tpu.encoder import intra as jintra
from x264_tpu.entropy import cavlc_jax
from x264_tpu.ops.pallas.commit import commit_i16_pallas
from x264_tpu.ops.tables import chroma_qp
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.entropy import cavlc_dev
from x264_tpu_torch.ops import commit as tcommit


def _t(a):
    return torch.from_numpy(np.array(a))


def _content(w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def _case_inputs(case):
    """Numpy inputs of the 5 cases of tests/test_pallas_commit.py."""
    if case in ("i16_seed0", "i16_seed7"):
        seed = 0 if case == "i16_seed0" else 7
        w, h = 48, 32
        y, u, v = _content(w, h, seed)
        rng = np.random.default_rng(100 + seed)
        qp = rng.integers(12, 44, (h // 16, w // 16)).astype(np.int32)
        extra = {}
    elif case in ("i4", "i4_mixed"):
        w, h = 64, 48
        y, u, v = _content(w, h, 11)
        rng = np.random.default_rng(12)
        qp = rng.integers(14, 42, (h // 16, w // 16)).astype(np.int32)
        i4_modes = np.asarray(jintra.decide_modes_i4(jnp.asarray(y))[0])
        i4_mask = rng.integers(0, 2, (h // 16, w // 16)).astype(bool)
        extra = dict(i4_mask=i4_mask, i4_modes=i4_modes)
        if case == "i4_mixed":
            extra["inter_planes"] = _content(w, h, 13)
            extra["is_intra"] = (rng.integers(0, 2, (h // 16, w // 16))
                                 .astype(bool) | i4_mask)
    else:                                   # mixed
        w, h = 48, 32
        y, u, v = _content(w, h, 3)
        rng = np.random.default_rng(5)
        extra = dict(inter_planes=_content(w, h, 4),
                     is_intra=rng.integers(0, 2, (h // 16, w // 16))
                     .astype(bool))
        qp = np.full((h // 16, w // 16), 28, np.int32)
    i16_mode, chroma_mode, _ = jintra.decide_modes(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    return dict(y=y, u=u, v=v, i16_mode=np.asarray(i16_mode),
                chroma_mode=np.asarray(chroma_mode), qp_mb=qp,
                qpc_mb=np.asarray(chroma_qp(qp), np.int32),
                mbw=w // 16, mbh=h // 16, **extra)


CASES = ["i16_seed0", "i16_seed7", "i4", "i4_mixed", "mixed"]


def _torch_args(inp):
    kw = {}
    for k in ("i4_mask", "i4_modes", "is_intra"):
        if k in inp:
            kw[k] = _t(inp[k])
    if "inter_planes" in inp:
        kw["inter_planes"] = [_t(p) for p in inp["inter_planes"]]
    args = [_t(inp[k]) for k in ("y", "u", "v", "i16_mode", "chroma_mode",
                                 "qp_mb", "qpc_mb")]
    return args + [inp["mbw"], inp["mbh"]], kw


def _scan(inp):
    """x264_tpu's commit scan on numpy inputs."""
    jkw = {k: jnp.asarray(inp[k]) for k in ("i4_mask", "i4_modes",
                                             "is_intra") if k in inp}
    if "inter_planes" in inp:
        jkw["inter_planes"] = [jnp.asarray(p) for p in inp["inter_planes"]]
    jargs = [jnp.asarray(inp[k]) for k in ("y", "u", "v", "i16_mode",
                                           "chroma_mode", "qp_mb", "qpc_mb")]
    return jintra._commit_scan(*jargs, inp["mbw"], inp["mbh"], **jkw)


@pytest.fixture(scope="module")
def commit_runs():
    """Per case: inputs, the port's commit_ref output, and the two JAX
    references (computed once for the module)."""
    runs = {}
    for case in CASES:
        inp = _case_inputs(case)
        scan = _scan(inp)
        pkw = {k: inp[k] for k in ("i4_mask", "i4_modes", "is_intra",
                                   "inter_planes") if k in inp}
        pallas = commit_i16_pallas(*[inp[k] for k in (
            "y", "u", "v", "i16_mode", "chroma_mode", "qp_mb", "qpc_mb")],
            mbw=inp["mbw"], mbh=inp["mbh"], interpret=True, **pkw)
        targs, tkw = _torch_args(inp)
        runs[case] = dict(inp=inp, scan=scan, pallas=pallas,
                          port=tcommit.commit_ref(*targs, **tkw))
    return runs


def _assert_commit_equal(ref, got):
    ref_coeffs, ref_recon = ref
    got_coeffs, got_recon = got
    for k in ("dc", "ac", "udc", "uac", "vdc", "vac"):
        g = got_coeffs[k].numpy()
        np.testing.assert_array_equal(
            np.asarray(ref_coeffs[k]).reshape(g.shape), g, err_msg=k)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(ref_recon[i]),
                                      got_recon[i].numpy(),
                                      err_msg=f"plane {i}")


@pytest.mark.parametrize("case", CASES)
def test_commit_ref_matches_scan(commit_runs, case):
    run = commit_runs[case]
    _assert_commit_equal(run["scan"], run["port"])


@pytest.mark.parametrize("case", CASES)
def test_commit_ref_matches_pallas_interpret(commit_runs, case):
    run = commit_runs[case]
    _assert_commit_equal(run["pallas"], run["port"])


@pytest.mark.parametrize("case", CASES)
def test_commit_ref_raster_order_matches_diagonals(commit_runs, case):
    """The frame kernel commits MB rows left to right, each row behind the
    one above; the plain per-MB steps driven one MB at a time in raster
    order give the diagonal order's bits."""
    run = commit_runs[case]
    args, kw = _torch_args(run["inp"])
    mbw, mbh = run["inp"]["mbw"], run["inp"]["mbh"]
    raster = [(torch.tensor([x]), torch.tensor([y]))
              for y in range(mbh) for x in range(mbw)]
    _assert_commit_equal(run["scan"],
                         tcommit.commit_ref(*args, order=raster, **kw))


@pytest.mark.parametrize("case", ["i4", "i4_mixed"])
def test_i4_wavefront_order_matches_zscan(commit_runs, case):
    """I_4x4 in the frame kernel's block order (a wavefront over
    bx + 2 by) gives the z-scan's levels and reconstruction, for every MB
    of the frame with its committed neighbours as edges."""
    assert sorted(tcommit.I4_WAVEFRONT) == list(range(16))
    inp = commit_runs[case]["inp"]
    _, recon = commit_runs[case]["port"]
    mbw, mbh = inp["mbw"], inp["mbh"]
    rec = torch.zeros((16 * mbh + 1, 16 * mbw + 1), dtype=torch.int32)
    rec[1:, 1:] = recon[0].to(torch.int32)
    ys, xs = [t.reshape(-1) for t in torch.meshgrid(
        torch.arange(mbh), torch.arange(mbw), indexing="ij")]
    top, left, tl = tcommit._edges(rec, xs, ys, 16)
    src = tcommit._tiles(_t(inp["y"]), xs, ys, 16)
    modes = _t(inp["i4_modes"])[ys, xs]
    qp = _t(inp["qp_mb"])[ys, xs]
    zscan = tcommit._i4_commit_mb(src, left, top, tl, xs > 0, ys > 0, modes,
                                  qp)
    wave = tcommit._i4_commit_mb(src, left, top, tl, xs > 0, ys > 0, modes,
                                 qp, order=tcommit.I4_WAVEFRONT)
    for z, w in zip(zscan, wave):
        assert torch.equal(z, w)
    # and on the MBs that committed as I_4x4, what commit_ref kept
    lane = _t(inp["i4_mask"])[ys, xs]
    if "is_intra" in inp:
        lane &= _t(inp["is_intra"])[ys, xs]
    assert torch.equal(wave[1][lane],
                       tcommit._tiles(recon[0], xs, ys, 16)[lane].to(
                           torch.int32))


def test_commit_on_cpu_tensors_takes_plain_version(commit_runs):
    run = commit_runs["i4_mixed"]
    args, kw = _torch_args(run["inp"])
    before = tcommit.commit.launches
    got = tcommit.commit(*args, **kw)
    assert tcommit.commit.launches == before
    _assert_commit_equal(run["scan"], got)


def test_commit_kernel_never_falls_back_on_cpu_tensors(commit_runs):
    """The kernel wrapper launches or raises: given CPU tensors it must
    raise, not return commit_ref's answer."""
    args, kw = _torch_args(commit_runs["i16_seed0"]["inp"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcommit.commit_cuda(*args, **kw)


def test_i4_wavefront_puts_every_block_after_its_neighbours():
    """Each block of I4_WAVEFRONT comes after its left, top and top-left
    blocks, and after its top-right block where that one is read ('real'
    kind), so the frame kernel's order reads only finished pixels."""
    pos = {r: n for n, r in enumerate(tcommit.I4_WAVEFRONT)}
    for r in range(16):
        bx, by = r % 4, r // 4
        deps = [(bx - 1, by), (bx, by - 1), (bx - 1, by - 1)]
        if tcommit._I4_KIND[r] == 2:
            deps.append((bx + 1, by - 1))
        for dx, dy in deps:
            if 0 <= dx < 4 and 0 <= dy < 4:
                assert pos[dy * 4 + dx] < pos[r], (r, dx, dy)


@pytest.mark.parametrize("fn", ["commit_launch", "commit_cuda_diag"])
def test_other_kernel_entries_refuse_cpu_tensors(commit_runs, fn):
    args, kw = _torch_args(commit_runs["i4"]["inp"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tcommit, fn)(*args, **kw)


@pytest.mark.parametrize("case", ["done", "timed_out", "unfinished"])
def test_check_progress(case):
    """The wrapper raises unless every row reached mbw and the error word
    (set when a wavefront wait runs past its bound) stayed 0."""
    prog = torch.tensor([5, 5, 5, 0], dtype=torch.int32)
    if case == "timed_out":
        prog[-1] = 1
    elif case == "unfinished":
        prog[1] = 3
    if case == "done":
        tcommit.check_progress(prog, 5)
    else:
        with pytest.raises(RuntimeError, match="bound|unfinished"):
            tcommit.check_progress(prog, 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the commit kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_commit_kernel_matches_ref(cuda_device, commit_runs, case):
    args, kw = _torch_args(commit_runs[case]["inp"])
    dev_args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                for a in args]
    dev_kw = {k: ([p.to(cuda_device) for p in v] if k == "inter_planes"
                  else v.to(cuda_device)) for k, v in kw.items()}
    coeffs, recon = tcommit.commit(*dev_args, **dev_kw)
    torch.cuda.synchronize()
    _assert_commit_equal(commit_runs[case]["port"],
                         ({k: v.cpu() for k, v in coeffs.items()},
                          [r.cpu() for r in recon]))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 2])
def test_commit_kernel_small_grid_and_stats(cuda_device, commit_runs, grid):
    """Fewer blocks than MB rows (each block walks several rows) give the
    same bits; the counters come back for every block."""
    args, kw = _torch_args(commit_runs["i4_mixed"]["inp"])
    dev_args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                for a in args]
    dev_kw = {k: ([p.to(cuda_device) for p in v] if k == "inter_planes"
                  else v.to(cuda_device)) for k, v in kw.items()}
    stats = torch.zeros((grid, len(tcommit.STATS_FIELDS)), dtype=torch.int64,
                        device=cuda_device)
    coeffs, recon, prog = tcommit.commit_launch(*dev_args, grid=grid,
                                                stats=stats, **dev_kw)
    tcommit.check_progress(prog, args[7])
    _assert_commit_equal(commit_runs["i4_mixed"]["port"],
                         ({k: v.cpu() for k, v in coeffs.items()},
                          [r.cpu() for r in recon]))
    fields = dict(zip(tcommit.STATS_FIELDS, stats.sum(0).tolist()))
    assert fields["mbs"] == args[7] * args[8]


# a batch is items of one shape and variant: the two seeds of the I16 case,
# or one case twice
BATCHES = [("i16_seed0", "i16_seed7"), ("i4", "i4"),
           ("i4_mixed", "i4_mixed"), ("mixed", "mixed")]


def _batch_calls(commit_runs, cases, device="cpu"):
    calls = []
    for case in cases:
        args, kw = _torch_args(commit_runs[case]["inp"])
        calls.append(([a.to(device) if isinstance(a, torch.Tensor) else a
                       for a in args],
                      {k: ([p.to(device) for p in v] if k == "inter_planes"
                           else v.to(device)) for k, v in kw.items()}))
    return calls


def _random_item(rng, variant):
    """One item of a random batch: random planes, I16 and chroma modes,
    QPs, and (as the variant asks) I_4x4 flags and modes and intra flags,
    at the size of the cases of the same variant."""
    w, h = (48, 32) if variant == "i16" else (64, 48)
    mbw, mbh = w // 16, h // 16
    y, u, v = _content(w, h, int(rng.integers(1 << 30)))
    qp = rng.integers(18, 40, (mbh, mbw)).astype(np.int32)
    inp = dict(y=y, u=u, v=v,
               i16_mode=rng.integers(0, 4, (mbh, mbw)).astype(np.int32),
               chroma_mode=rng.integers(0, 4, (mbh, mbw)).astype(np.int32),
               qp_mb=qp, qpc_mb=np.asarray(chroma_qp(qp), np.int32),
               mbw=mbw, mbh=mbh)
    if variant != "i16":
        inp["i4_mask"] = rng.random((mbh, mbw)) < 0.5
        inp["i4_modes"] = rng.integers(0, 9, (mbh, mbw, 16)).astype(np.int32)
    if variant == "mixed_i4":
        inp["is_intra"] = (rng.random((mbh, mbw)) < 0.6) | inp["i4_mask"]
        inp["inter_planes"] = _content(w, h, int(rng.integers(1 << 30)))
    return inp


# batches of 3 items with random modes (each item a frame of its own)
RANDOM_BATCHES = ["i16", "i16_i4", "mixed_i4"]


@pytest.mark.parametrize(
    "cases", BATCHES + [f"random_{v}" for v in RANDOM_BATCHES],
    ids=lambda c: c if isinstance(c, str) else "+".join(c))
def test_commit_ref_batch_matches_scan_per_item(commit_runs, cases):
    """commit_ref over a batch (a leading item axis) gives each item what
    x264_tpu's scan gives it alone: pairs of the cases above, and batches
    of 3 items with random modes; commit_batch hands back each item's
    outputs."""
    if isinstance(cases, str):
        rng = np.random.default_rng(7)
        inps = [_random_item(rng, cases[len("random_"):]) for _ in range(3)]
        calls, refs = [_torch_args(inp) for inp in inps], map(_scan, inps)
    else:
        calls = _batch_calls(commit_runs, cases)
        refs = (commit_runs[case]["scan"] for case in cases)
    for ref, got in zip(refs, tcommit.commit_batch(calls)):
        _assert_commit_equal(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, 1])
@pytest.mark.parametrize("cases", BATCHES, ids="+".join)
def test_commit_kernel_batch_matches_ref(cuda_device, commit_runs, cases,
                                         grid):
    """One launch for the batch, each item equal to commit_ref's; with one
    block the block walks every row of both items."""
    args, kw = tcommit.stack_calls(_batch_calls(commit_runs, cases,
                                                cuda_device))
    n0 = tcommit.commit.launches
    coeffs, recon, prog = tcommit.commit_launch(*args, grid=grid, **kw)
    tcommit.check_progress(prog, args[7])
    assert tcommit.commit.launches == n0 + 1
    for b, case in enumerate(cases):
        _assert_commit_equal(commit_runs[case]["port"],
                             ({k: v[b].cpu() for k, v in coeffs.items()},
                              [r[b].cpu() for r in recon]))


# ---------------------------------------------------------------- decision
def test_mb_lambda_matches_jax_for_every_qp():
    qp = np.arange(52, dtype=np.int32)
    ref = jnp.maximum(1, jnp.round(2.0 ** ((jnp.asarray(qp) - 12) / 6.0))) \
        .astype(jnp.int32)
    np.testing.assert_array_equal(np.asarray(ref),
                                  tintra.mb_lambda(_t(qp)).numpy())


@pytest.fixture(scope="module")
def frame64():
    y, u, v = _content(64, 48, 21)
    qp = np.random.default_rng(22).integers(0, 52, (3, 4)).astype(np.int32)
    lam = tintra.mb_lambda(_t(qp)).numpy()
    return y, u, v, lam


@pytest.mark.parametrize("with_lam", [False, True])
def test_decide_modes_full_matches_jax(frame64, with_lam):
    y, u, v, lam = frame64
    lam = lam if with_lam else None
    ref = jintra.decide_modes_full(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        lam=None if lam is None else jnp.asarray(lam))
    got = tintra.decide_modes_full(_t(y), _t(u), _t(v),
                                   lam=None if lam is None else _t(lam))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("with_lam", [False, True])
def test_decide_modes_i4_matches_jax(frame64, with_lam):
    y, _, _, lam = frame64
    lam = lam if with_lam else None
    ref = jintra.decide_modes_i4(jnp.asarray(y),
                                 lam=None if lam is None else jnp.asarray(lam))
    got = tintra.decide_modes_i4(_t(y), lam=None if lam is None else _t(lam))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


# ---------------------------------------------------------------- CAVLC
@pytest.mark.parametrize("variant", ["i16", "i4", "overflow"])
def test_encode_i16x16_frame_dev_matches_jax(variant):
    w, h = 64, 48
    mbw, mbh = w // 16, h // 16
    n = mbw * mbh
    rng = np.random.default_rng({"i16": 30, "i4": 31, "overflow": 32}
                                [variant])
    y, u, v = _content(w, h, 33)
    lo, hi = (0, 6) if variant == "overflow" else (18, 34)
    qp = rng.integers(lo, hi, (mbh, mbw)).astype(np.int32)
    qpc = np.asarray(chroma_qp(qp), np.int32)
    m, cm, _, c16 = tintra.decide_modes_full(_t(y), _t(u), _t(v))
    kw = {}
    if variant != "i16":
        m4, c4 = tintra.decide_modes_i4(_t(y))
        kw = dict(i4_mask=c4 < c16, i4_modes=m4)
    coeffs, _ = tcommit.commit_ref(_t(y), _t(u), _t(v), m, cm, _t(qp),
                                   _t(qpc), mbw, mbh, **kw)
    args = [m.reshape(-1), cm.reshape(-1), _t(qp).reshape(-1),
            int(qp[0, 0]), coeffs["dc"], coeffs["ac"],
            torch.stack([coeffs["udc"], coeffs["vdc"]], 1),
            torch.stack([coeffs["uac"], coeffs["vac"]], 1)]
    i4kw = {}
    if kw:
        i4kw = dict(is_i4=kw["i4_mask"].reshape(-1),
                    i4_modes=kw["i4_modes"].reshape(-1, 16))
    cap_words = n * 450 // 4
    ref = cavlc_jax.encode_i16x16_frame_dev(
        *[a if isinstance(a, int) else jnp.asarray(a.numpy()) for a in args],
        mbw=mbw, mbh=mbh, cap_words=cap_words,
        **{k: jnp.asarray(v.numpy()) for k, v in i4kw.items()})
    got = cavlc_dev.encode_i16x16_frame_dev(*args, mbw=mbw, mbh=mbh,
                                            cap_words=cap_words, **i4kw)
    assert int(ref[1]) == int(got[1])
    assert (int(got[1]) == cap_words * 32) == (variant == "overflow")
    np.testing.assert_array_equal(np.asarray(ref[0]).astype(np.int64),
                                  got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), got[2].numpy())


@pytest.mark.parametrize("mb_cap_words", [60, 30, 4])
def test_pack_mb_stream_matches_jax(mb_cap_words):
    rng = np.random.default_rng(40)
    lens = rng.integers(0, 33, (7, 50)).astype(np.int32)
    mask = (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    codes = (rng.integers(0, 2 ** 32, (7, 50), dtype=np.uint64)
             & mask).astype(np.uint32)
    cap = 7 * mb_cap_words
    ref = cavlc_jax.pack_mb_stream(jnp.asarray(codes), jnp.asarray(lens),
                                   mb_cap_words, cap)
    got = cavlc_dev.pack_mb_stream(_t(codes.astype(np.int64)), _t(lens),
                                   mb_cap_words, cap)
    assert int(ref[1]) == int(got[1])
    np.testing.assert_array_equal(np.asarray(ref[0]).astype(np.int64),
                                  got[0].numpy())


def test_words_to_bytes_matches_jax():
    words = np.array([0x12345678, 0x9ABCDEF0, 0xFFFFFFFF], np.uint32)
    for bits in (0, 1, 33, 70, 96):
        assert (cavlc_dev.words_to_bytes(words.astype(np.int64), bits)
                == cavlc_jax.words_to_bytes(words, bits))
