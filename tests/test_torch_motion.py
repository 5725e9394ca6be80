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
kernels by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
