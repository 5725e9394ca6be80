"""The port's motion searches against x264_tpu's compiled scans, on inputs
full of ties, and the plain versions of the motion kernels
(csrc/motion.cu).

Each search is run three ways on the same inputs (made with numpy from a
seed): x264_tpu's jnp scan (jax.jit, CPU), the port's public function on
CPU tensors (its sequential plain version, `*_ref`), and the kernels'
order (ops/motion.py `lowres_scan_plain`, `fullpel_plain`,
`subpel_plain`: every candidate's cost, then the first minimum over
(cost, scan index)), which the card holds each kernel against. Every
output is an integer: every comparison is exact (tolerance 0). Ties come
from flat frames, a texture of period 4 (its SADs tie at offsets 4
apart), lam 0 (no MV rate to part them) and the periodic-intra-refresh
cap; a large lam is covered too. All frames are 48x32 (mbw 3, mbh 2).
Each JAX search compiles once per me_range, and its compile is most of
this file's time, so each runs at few: the ESA at the presets' largest
me_range, 24 (where the most offsets tie); the seeded search and the qpel
refine at 4 (the seeds clamp to 0) and, on the moving clip, at 24.
me_range 16, the default, is held against x264_tpu by the encode tests
(tests/test_torch_inter.py, tests/test_torch_bframe*.py) and against the
kernels by chip_smoke.py.

The branches of the kernels' mapping have cases of their own, made by
tests/motion_branches.py (chip_smoke.py meets the kernels with the same
inputs on the card): qpel lanes whose full-pel MVs equal the 16x16
lane's, copy another lane's or differ (the me_subpel kernel computes a
(lane, 4x4 block) once per distinct MV), windows past the plane's edges
(the kernels' clamp path), at 1, 5 and 9 lanes; and the ESA at me_range
32, whose windows reach the plane's right edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from motion_branches import LANE_KINDS, refine_edge_cases, subpel_lane_cases
from test_inter_e2e import moving_frames
from test_torch_inter import _eq, _ref_entry, _t
from x264_tpu.encoder import inter as jinter
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.ops import _cuda, mc
from x264_tpu_torch.ops import motion as tmotion

W, H = 48, 32
MBW, MBH = W // 16, H // 16
REFINE = 4
ESA_RANGE = 24

# name: (content, lam, me_range of the seeded search and the qpel refine,
# with the PIR cap)
CASES = {
    "flat": ("flat", 6, 4, False),
    "periodic_lam0": ("periodic", 0, 4, False),
    "periodic_lam200": ("periodic", 200, 4, False),
    "periodic_pir_cap": ("periodic", 6, 4, True),
    "moving": ("moving", 6, 24, False),
}
# the cap on each MB column's full-pel dx: a few offsets left, about
# half of them, none capped
PIR_CAP = np.broadcast_to(np.array([-4, 1, 1 << 20], np.int32), (MBH, MBW))
# x264_tpu gets this cap where the port gets None: it caps nothing, and
# each JAX search then compiles once per me_range
NO_CAP = np.full((MBH, MBW), 1 << 20, np.int32)


def _frames(content, seed=11):
    """(current luma, reference planes) at 48x32."""
    yy, xx = np.mgrid[0:H, 0:W]
    if content == "flat":
        ref = [np.full(s, 93, np.uint8) for s in ((H, W), (H // 2, W // 2),
                                                   (H // 2, W // 2))]
        return np.full((H, W), 90, np.uint8), ref
    if content == "periodic":
        tex = ((xx % 4) * 40 + (yy % 4) * 25 + 20).astype(np.uint8)
        noise = np.random.default_rng(seed).integers(0, 2, (H, W))
        ref = [np.roll(tex, (1, 2), (0, 1)),
               np.full((H // 2, W // 2), 128, np.uint8),
               np.full((H // 2, W // 2), 128, np.uint8)]
        return (tex + noise).astype(np.uint8), ref
    frames = moving_frames(2, W, H, seed=seed)
    return frames[1][0], frames[0]


def _case(name):
    content, lam, me_range, pir = CASES[name]
    y, ref = _frames(content)
    jref, tref = _ref_entry(ref)
    return y, jref, tref, lam, me_range, (PIR_CAP if pir else None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread. The searches are
    thousands of small ops, and on a CPU whose cores are busy with other
    work each parallel region of torch's intra-op pool waits for them: a
    me_range-24 ESA (motion_search_ref and the kernel's order) took 24 s
    on 8 threads of a loaded 8-core CPU and 0.3 s on one. The results do
    not depend on the thread count (integer ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_jax_esa = jax.jit(jinter.motion_search, static_argnums=(4, 5))
_jax_seeded = jax.jit(jinter.motion_search_seeded, static_argnums=(3, 4))
_jax_subpel_all = jax.jit(jinter.subpel_refine_all,
                          static_argnames=("me_range", "p8x8"))
_jax_subpel_mc = jax.jit(jinter.subpel_refine_mc,
                         static_argnames=("me_range",))


def _jax_cap(cap):
    return jnp.asarray(NO_CAP if cap is None else cap)


def _torch_cap(cap):
    return None if cap is None else _t(cap)


def _eq_fields(want, *gots):
    for got in gots:
        assert set(got) == set(want)
        for key in want:
            _eq(want[key], got[key], key)


def _esa_plain(tref, y, lam, me_range, cap, shapes):
    """motion_search in the me_esa kernel's order: two passes of
    fullpel_plain with the MVP estimate between them."""
    mv1 = tmotion.fullpel_plain(tref["y_pad"], y, None, None, lam, me_range,
                               False, cap)
    mvp, _ = tinter.mv_predictors(mv1 * 4)
    return tmotion.fullpel_plain(tref["y_pad"], y, None, mvp, lam, me_range,
                                shapes, cap)


@pytest.mark.parametrize("name", list(CASES))
def test_esa_matches_x264_tpu(name):
    """The exhaustive search (both passes, every partition lane) at
    me_range 24: x264_tpu == motion_search on the CPU (motion_search_ref)
    == the kernel's order."""
    y, jref, tref, lam, _, cap = _case(name)
    me_range = ESA_RANGE
    want = _jax_esa(jref["y_pad"], None, jnp.asarray(y), lam, me_range, True,
                    _jax_cap(cap))
    got = tinter.motion_search(tref["y_pad"], None, _t(y), lam, me_range,
                               shapes=True, pir_cap=_torch_cap(cap))
    plain = _esa_plain(tref, _t(y), lam, me_range, _torch_cap(cap), True)
    _eq_fields(want, got, plain)


def test_esa_16x16_lane_alone_matches_x264_tpu():
    """shapes=False: the 16x16 lane alone, on the flat frame where every
    offset ties, against x264_tpu's 16x16 lane (which it tracks the same
    with or without the partition lanes)."""
    y, jref, tref, lam, _, _ = _case("flat")
    me_range = ESA_RANGE
    want = _jax_esa(jref["y_pad"], None, jnp.asarray(y), lam, me_range,
                    True, _jax_cap(None))["16x16"]
    _eq(want, tinter.motion_search(tref["y_pad"], None, _t(y), lam, me_range))
    _eq(want, _esa_plain(tref, _t(y), lam, me_range, None, False))


@pytest.mark.parametrize("name", list(CASES))
def test_seeded_matches_x264_tpu(name):
    """The seeded search: x264_tpu == motion_search_seeded on the CPU ==
    the kernels' order (lowres_scan_plain, the seed and its MVP estimate,
    fullpel_plain around the seeds)."""
    y, jref, tref, lam, me_range, cap = _case(name)
    want = _jax_seeded(jref["y_pad"], jnp.asarray(y), lam, me_range, True,
                       _jax_cap(cap))
    yt = _t(y)
    got = tinter.motion_search_seeded(tref["y_pad"], yt, lam, me_range,
                                      shapes=True, pir_cap=_torch_cap(cap))
    rl = (me_range + 1) // 2
    lref = mc._clamped(tinter._lowres(tref["y_pad"][mc.PAD:mc.PAD + H,
                                                    mc.PAD:mc.PAD + W]),
                       rl + 1, rl + 1, rl + 1, rl + 1)
    bm = tmotion.lowres_scan_plain(tinter._lowres(yt), lref, rl, lam)
    seed = (2 * bm).clamp(-(me_range - REFINE), me_range - REFINE)
    mvp, _ = tinter.mv_predictors(seed * 4)
    plain = tmotion.fullpel_plain(tref["y_pad"], yt, seed, mvp, lam, REFINE,
                                 True, _torch_cap(cap))
    _eq_fields(want, got, plain)


@pytest.mark.parametrize("name", ["flat", "periodic_lam0",
                                  "periodic_lam200"])
@pytest.mark.parametrize("lanes", [1, 5, 9])
def test_subpel_matches_x264_tpu(lanes, name):
    """The qpel refine of 1 lane (subpel_refine_mc, no MVP: the B path),
    5 lanes (no P_8x8) and 9, at each lane's ESA winner: x264_tpu == the
    port on the CPU (*_ref) == subpel_plain (the me_subpel kernel's
    order); MVs, predictions and costs."""
    y, jref, tref, lam, me_range, _ = _case(name)
    yt = _t(y)
    mvs = tinter.motion_search(tref["y_pad"], None, yt, lam, me_range,
                               shapes=True)
    tab = _t(tinter._subpel_cand_table(3))
    if lanes == 1:
        want = _jax_subpel_mc(jref["hpel"], jnp.asarray(y),
                              jnp.asarray(mvs["16x16"].numpy()), lam,
                              me_range=me_range)
        got = tinter.subpel_refine_mc(tref["hpel"], yt, mvs["16x16"], lam,
                                      me_range)
        plain = tmotion.subpel_plain(tref["hpel"], yt, mvs["16x16"][None],
                                    torch.ones((1, 16), dtype=torch.int32),
                                    tab, lam)
        for w_, g, p in zip(want, got, plain):
            _eq(w_, g)
            _eq(w_, p[0])
        return
    mvp = tinter.mv_predictors(mvs["16x16"] * 4)[0].reshape(-1, 2)
    want = _jax_subpel_all(jref["hpel"], jnp.asarray(y),
                           {k: jnp.asarray(v.numpy()) for k, v in mvs.items()},
                           lam, me_range=me_range,
                           mvp_q=jnp.asarray(mvp.numpy()), p8x8=lanes == 9)
    got = tinter.subpel_refine_all(tref["hpel"], yt, mvs, lam, me_range,
                                   mvp_q=mvp, p8x8=lanes == 9)
    lane_mv = torch.stack(
        [mvs["16x16"], *mvs["16x8"].unbind(2), *mvs["8x16"].unbind(2)]
        + (list(mvs["8x8"].unbind(2)) if lanes == 9 else []))
    bq, bp, bc = tmotion.subpel_plain(
        tref["hpel"], yt, lane_mv, _t(tinter._PART_MASKS[:lanes]), tab, lam,
        mvp)
    # each partition lane's prediction over its own partition, as
    # subpel_refine_all slices it
    plain_parts = (bp[1, :, 0:8, :], bp[2, :, 8:16, :], bp[3, :, :, 0:8],
                   bp[4, :, :, 8:16])
    if lanes == 9:
        plain_parts += (bp[5, :, 0:8, 0:8], bp[6, :, 0:8, 8:16],
                        bp[7, :, 8:16, 0:8], bp[8, :, 8:16, 8:16])
    assert len(want[4]) == len(got[4]) == len(plain_parts) == lanes - 1
    for k, w_ in enumerate(want):
        if k == 4:                       # the partitions' predictions
            for wp, gp, pp in zip(w_, got[4], plain_parts):
                _eq(wp, gp)
                _eq(wp, pp)
        else:
            _eq(w_, got[k])
    _eq(want[0], bq[0])
    _eq(want[1], bp[0])
    _eq(want[2], bc[0])
    _eq(want[3], bq[1:])
    _eq(want[5], bc[1:])


def test_esa_to_the_plane_edge_matches_x264_tpu():
    """The ESA at me_range 32, the largest the kernel takes: the last MB
    column's window reaches the padded plane's right edge, so the kernel
    loads it through its clamp path. x264_tpu == motion_search_ref == the
    kernel's order, every lane."""
    y, jref, tref, lam, _, _ = _case("moving")
    want = _jax_esa(jref["y_pad"], None, jnp.asarray(y), lam, 32, True,
                    _jax_cap(None))
    got = tinter.motion_search(tref["y_pad"], None, _t(y), lam, 32,
                               shapes=True)
    _eq_fields(want, got, _esa_plain(tref, _t(y), lam, 32, None, True))


def test_fullpel_plain_clamps_windows_past_the_edges():
    """fullpel_plain (the me_fullpel kernel's order) around seeds 20-40
    pixels past each edge of the plane (motion_branches.refine_edge_cases,
    the inputs the kernel meets on the card): every window row and column
    clamped to the padded plane, each lane the first least (SAD + MV
    rate) in scan order, against numpy written out offset by offset."""
    n = 0
    for label, launch, plain, args in refine_edge_cases(*_lane_pair("cpu")):
        if launch is not tmotion.refine_launch:   # the ESA: tested above
            continue
        yp, y, seed, mvp, lam, radius, shapes = args
        got = plain(*args)
        got = got if shapes else {"16x16": got}
        ref, src = yp.numpy().astype(np.int64), y.numpy().astype(np.int64)
        for my, mx in np.ndindex(MBH, MBW):
            best = {}
            for dy, dx in np.ndindex(2 * radius + 1, 2 * radius + 1):
                mv = (int(seed[my, mx, 0]) + dx - radius,
                      int(seed[my, mx, 1]) + dy - radius)
                rows = np.clip(mc.PAD + 16 * my + mv[1] + np.arange(16), 0,
                               ref.shape[0] - 1)
                cols = np.clip(mc.PAD + 16 * mx + mv[0] + np.arange(16), 0,
                               ref.shape[1] - 1)
                q = np.abs(ref[rows][:, cols]
                           - src[16 * my:16 * my + 16, 16 * mx:16 * mx + 16]
                           ).reshape(2, 8, 2, 8).sum((1, 3)).reshape(4)
                rate = lam * (tinter._mv_bits(4 * mv[0] - int(mvp[my, mx, 0]))
                              + tinter._mv_bits(4 * mv[1]
                                                - int(mvp[my, mx, 1])))
                costs = {"16x16": [q.sum()],
                         "16x8": [q[0] + q[1], q[2] + q[3]],
                         "8x16": [q[0] + q[2], q[1] + q[3]], "8x8": q}
                for key in got:
                    for part, c in enumerate(costs[key]):
                        if c + rate < best.get((key, part), (1 << 30,))[0]:
                            best[key, part] = (c + rate, mv)
            for (key, part), (_, mv) in best.items():
                at = got[key][my, mx]
                assert tuple((at if key == "16x16" else at[part]).tolist()) \
                    == mv, (label, key, part)
        n += 1
    assert n == 4


def _lane_pair(dev):
    """The 48x32 (current, reference) luma pair of the branch cases, and
    the device."""
    frames = moving_frames(2, W, H, seed=11)
    return frames[1][0], frames[0][0], torch.device(dev)


def _wrapped_windows(lane_mv):
    """[L, n] bool: the (lane, MB)s whose 24x24 qpel window starts left of
    or above the padded plane, where x264_tpu's jnp gather wraps the
    negative index and the port clamps it."""
    mv = lane_mv.numpy().reshape(lane_mv.shape[0], -1, 2)
    my, mx = np.divmod(np.arange(MBH * MBW), MBW)
    return ((mc.PAD + 16 * mx + mv[..., 0] - tinter.SUBPEL_MARG < 0)
            | (mc.PAD + 16 * my + mv[..., 1] - tinter.SUBPEL_MARG < 0))


def _per_lane(out, lanes):
    """A qpel refine's result as one (MVs [n, 2], prediction, costs [n])
    per lane: subpel_refine_mc's (mv, pred, cost), or subpel_refine_all's
    16x16 lane and then its partition lanes."""
    if lanes == 1:
        return [tuple(out)]
    return [tuple(out[:3])] + [(out[3][k], out[4][k], out[5][k])
                               for k in range(lanes - 1)]


LANE_CASES = [(kind, lanes) for kind in LANE_KINDS for lanes in (1, 5, 9)]


@pytest.mark.parametrize("kind,lanes", LANE_CASES)
def test_subpel_lanes_match_x264_tpu(kind, lanes):
    """The qpel refine at lane MVs that equal the 16x16 lane's, copy
    another lane's or differ, and past the plane's edges, at 1 lane
    (subpel_refine_mc, no MVP), 5 and 9 (subpel_refine_all with an MVP;
    motion_branches.subpel_lane_cases): subpel_plain (the me_subpel kernel's
    order) == the port's *_ref == x264_tpu. Where a lane's window starts
    left of or above the padded plane, x264_tpu's jnp gather wraps the
    negative index and the port clamps it (ROADMAP F9; the encoder's
    searches reach no edge, |mv| <= me_range <= PAD - 8): x264_tpu is held
    to the port on every other (lane, MB), and the edge_near cases must
    have (lane, MB)s of both kinds."""
    label = f"48x32 lanes {kind}, L {lanes}"
    y, hp, mv, mvp, lam = next(c[1:] for c in subpel_lane_cases(
        *_lane_pair("cpu")) if c[0] == label)
    tab = _t(tinter._subpel_cand_table(3))
    bq, bp, bc = tmotion.subpel_plain(hp, y, mv,
                                      _t(tinter._PART_MASKS[:lanes]), tab,
                                      lam, mvp)
    jhp, jy = jnp.asarray(hp.numpy()), jnp.asarray(y.numpy())
    if lanes == 1:
        got = tinter.subpel_refine_mc_ref(hp, y, mv[0], lam, REFINE)
        for g, p in zip(got, (bq, bp, bc)):
            _eq(g, p[0])
        want = _jax_subpel_mc(jhp, jy, jnp.asarray(mv[0].numpy()), lam,
                              me_range=REFINE)
    else:
        mvs = {"16x16": mv[0], "16x8": torch.stack([mv[1], mv[2]], 2),
               "8x16": torch.stack([mv[3], mv[4]], 2),
               "8x8": torch.stack(list(mv[5:]) if lanes == 9
                                  else [mv[0]] * 4, 2)}
        got = tinter.subpel_refine_all_ref(hp, y, mvs, lam, REFINE,
                                           mvp_q=mvp, p8x8=lanes == 9)
        _eq(got[0], bq[0])
        _eq(got[1], bp[0])
        _eq(got[2], bc[0])
        _eq(got[3], bq[1:])
        _eq(got[5], bc[1:])
        want = _jax_subpel_all(jhp, jy, {k: jnp.asarray(v.numpy())
                                         for k, v in mvs.items()},
                               lam, me_range=REFINE,
                               mvp_q=jnp.asarray(mvp.numpy()),
                               p8x8=lanes == 9)
    wrapped = _wrapped_windows(mv)
    if kind == "edge_near":
        assert wrapped.any() and not wrapped.all(), wrapped
    else:
        assert not wrapped.any(), wrapped
    for lane, (w_lane, g_lane) in enumerate(zip(_per_lane(want, lanes),
                                                _per_lane(got, lanes))):
        keep = ~wrapped[lane]
        for w_, g in zip(w_lane, g_lane):
            _eq(np.asarray(w_)[keep], g.numpy()[keep], f"lane {lane}")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the public searches are their *_ref bodies and
    launch nothing."""
    y, _, tref, lam, me_range, cap = _case("periodic_pir_cap")
    yt, cap = _t(y), _torch_cap(cap)
    before = [fn.launches for fn in tmotion.LAUNCHES]
    _eq_fields(tinter.motion_search_ref(tref["y_pad"], None, yt, lam,
                                        me_range, True, cap),
               tinter.motion_search(tref["y_pad"], None, yt, lam, me_range,
                                    True, cap))
    mvs = tinter.motion_search_seeded(tref["y_pad"], yt, lam, me_range, True,
                                      cap)
    _eq_fields(tinter.motion_search_seeded_ref(tref["y_pad"], yt, lam,
                                               me_range, True, cap), mvs)
    for w_, g in zip(tinter.subpel_refine_mc_ref(tref["hpel"], yt,
                                                 mvs["16x16"], lam, me_range),
                     tinter.subpel_refine_mc(tref["hpel"], yt, mvs["16x16"],
                                             lam, me_range)):
        _eq(w_, g)
    want = tinter.subpel_refine_all_ref(tref["hpel"], yt, mvs, lam, me_range)
    got = tinter.subpel_refine_all(tref["hpel"], yt, mvs, lam, me_range)
    for k in (0, 1, 2, 3, 5):
        _eq(want[k], got[k])
    assert [fn.launches for fn in tmotion.LAUNCHES] == before


def _launch_inputs():
    """Well-formed inputs of each launch wrapper, as CPU tensors."""
    y, _, tref, lam, _, _ = _case("periodic_lam200")
    yt = _t(y)
    i32 = torch.int32
    lsrc = tinter._lowres(yt)
    mv = torch.zeros((MBH, MBW, 2), dtype=i32)
    return {
        "lowres_scan": (tmotion.lowres_scan_launch,
                        [lsrc, torch.zeros((H // 2 + 18, W // 2 + 18),
                                           dtype=i32), 8, lam]),
        "refine": (tmotion.refine_launch,
                   [tref["y_pad"], yt, mv, mv, lam, REFINE, True]),
        "esa": (tmotion.esa_launch, [tref["y_pad"], yt, None, lam, 16, True]),
        "subpel": (tmotion.subpel_launch,
                   [tref["hpel"], yt, mv[None], torch.ones((1, 16),
                                                           dtype=i32),
                    _t(tinter._subpel_cand_table(3)), lam]),
    }


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if a wrapper reaches the kernels' library (nvcc)."""
    def refuse():
        raise AssertionError("a wrapper reached the kernels' library")
    monkeypatch.setattr(_cuda, "library", refuse)
    monkeypatch.setattr(tmotion, "_LIB", {})


@pytest.mark.parametrize("kernel", ["lowres_scan", "refine", "esa",
                                    "subpel"])
def test_launch_wrappers_check_before_the_library(kernel, no_library,
                                                  monkeypatch):
    """Each *_launch raises, without building or loading the library, on
    CPU tensors; with the device check passed (the tensors stand in for
    CUDA ones), on a wrong dtype, a wrong shape or a lam that is not a
    host integer."""
    fn, args = _launch_inputs()[kernel]
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    monkeypatch.setattr(tmotion, "_device", lambda t, name: t.device)
    y_at = 0 if kernel == "lowres_scan" else 1
    bad_dtype = list(args)
    bad_dtype[y_at] = args[y_at].to(torch.int16)
    bad_shape = list(args)
    bad_shape[y_at - 1 if y_at else 1] = args[y_at - 1 if y_at else 1][:-1]
    bad_lam = list(args)
    bad_lam[{"lowres_scan": 3, "refine": 4, "esa": 3,
             "subpel": 5}[kernel]] = torch.tensor(6)
    with pytest.raises(TypeError, match="dtype"):
        fn(*bad_dtype)
    with pytest.raises(ValueError, match="shape"):
        fn(*bad_shape)
    with pytest.raises(TypeError, match="host integer"):
        fn(*bad_lam)
    assert fn.launches == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the motion kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_motion_kernels_match_their_plain_versions(cuda_device, name):
    """Each search through its kernels against its plain version on the
    card, tolerance 0: the ESA, the seeded search and the 9-lane and
    1-lane qpel refines."""
    y, _, tref, lam, me_range, cap = _case(name)
    dev = cuda_device
    yt, yp, hp = _t(y).to(dev), tref["y_pad"].to(dev), tref["hpel"].to(dev)
    cap = None if cap is None else _t(cap).to(dev)
    n0 = [fn.launches for fn in tmotion.LAUNCHES]
    got = tinter.motion_search(yp, None, yt, lam, me_range, True, cap)
    _eq_fields({k: v.cpu() for k, v in tinter.motion_search_ref(
        yp, None, yt, lam, me_range, True, cap).items()},
        {k: v.cpu() for k, v in got.items()})
    mvs = tinter.motion_search_seeded(yp, yt, lam, me_range, True, cap)
    _eq_fields({k: v.cpu() for k, v in tinter.motion_search_seeded_ref(
        yp, yt, lam, me_range, True, cap).items()},
        {k: v.cpu() for k, v in mvs.items()})
    mvp = tinter.mv_predictors(mvs["16x16"] * 4)[0].reshape(-1, 2)
    want = tinter.subpel_refine_all_ref(hp, yt, mvs, lam, me_range,
                                        mvp_q=mvp)
    got = tinter.subpel_refine_all(hp, yt, mvs, lam, me_range, mvp_q=mvp)
    for k in (0, 1, 2, 3, 5):
        _eq(want[k].cpu(), got[k].cpu())
    for w_, g in zip(tinter.subpel_refine_mc_ref(hp, yt, mvs["16x16"], lam,
                                                 me_range),
                     tinter.subpel_refine_mc(hp, yt, mvs["16x16"], lam,
                                             me_range)):
        _eq(w_.cpu(), g.cpu())
    torch.cuda.synchronize()
    assert [fn.launches - a for fn, a in zip(tmotion.LAUNCHES, n0)] == \
        [1, 1, 2, 2]


def test_subpel_launch_takes_at_most_nine_lanes(no_library, monkeypatch):
    """subpel_launch (one block per MB over every lane) raises on a tenth
    lane before it reaches the library."""
    fn, args = _launch_inputs()["subpel"]
    monkeypatch.setattr(tmotion, "_device", lambda t, name: t.device)
    args[2] = args[2].expand(10, -1, -1, -1).contiguous()
    args[3] = args[3].expand(10, -1).contiguous()
    with pytest.raises(ValueError, match="L <= 9"):
        fn(*args)


@pytest.mark.cuda
def test_subpel_kernels_match_on_the_lane_cases(cuda_device):
    """me_subpel_kernel against subpel_plain on the card, tolerance 0, on
    every lane case (equal, copied and distinct lane MVs, windows past
    each edge; 1, 5 and 9 lanes), with the lanes' partition masks and with
    random weights 0-3."""
    tab = _t(tinter._subpel_cand_table(3)).to(cuda_device)
    rng = np.random.default_rng(4)
    for label, y, hp, mv, mvp, lam in subpel_lane_cases(
            *_lane_pair(cuda_device)):
        lanes = mv.shape[0]
        for masks in (tinter._PART_MASKS[:lanes],
                      rng.integers(0, 4, (lanes, 16)).astype(np.int32)):
            args = (hp, y, mv, _t(masks).to(cuda_device), tab, lam, mvp)
            want = tmotion.subpel_plain(*args)
            for w_, g in zip(want, tmotion.subpel_launch(*args)):
                _eq(w_.cpu(), g.cpu(), label)
