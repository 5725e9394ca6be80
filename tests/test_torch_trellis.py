"""The port's trellis quantization and adaptive quantization against
their JAX twins in x264_tpu, on seeded numpy inputs.

Tolerances. `frame_ctx_costs` is numpy on both sides: equal. `trellis_4x4`:
the re-quantized levels are equal; the float32 winning scores agree within
1e-5 relative (they come out bit-equal: the port reproduces the fused
multiply-add XLA makes of `score + ssd + lam2 * bits`). `aq_offsets` is
float32 through a log2 that XLA and PyTorch round differently in the last
bits: within 5e-6 absolute (offsets span about -7..+7); the integer QP
maps that `build_qp_maps` rounds them to are equal."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x264_tpu.encoder import frame_encode as jfe
from x264_tpu.ops import aq as jaq
from x264_tpu.ops import tables as jtables
from x264_tpu.ops import trellis as jtrellis
from x264_tpu_torch.encoder import frame_encode as tfe
from x264_tpu_torch.ops import aq as taq
from x264_tpu_torch.ops import trellis as ttrellis


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("name", ["ENT", "NEXT", "UNARY_COST", "UNARY_TRANS",
                                  "W2_ZIG4", "UNQ4_ZIG", "LAM2_INTER",
                                  "LAM2_INTRA", "_T1", "_TN"])
def test_trellis_tables_match_x264_tpu(name):
    ref, got = getattr(jtrellis, name), getattr(ttrellis, name)
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("slice_i", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("qp", [18, 26, 34, 42])
def test_frame_ctx_costs_match_x264_tpu(slice_i, qp):
    ref = jtrellis.frame_ctx_costs(slice_i, qp, cat=2)
    got = ttrellis.frame_ctx_costs(slice_i, qp, cat=2)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- trellis
def _seeded_blocks(seed, n=3000):
    """Transform coefficients with a Laplacian spread, a tenth of the
    blocks scaled up so that their levels pass 15 (the EG0 suffix), sixty
    all-zero blocks, a per-block QP of 10..44 and the deadzone levels the
    inter quantizer gives them, all in zigzag order."""
    rng = np.random.default_rng(seed)
    qp = rng.integers(10, 45, n).astype(np.int32)
    w = rng.laplace(0, 60, (n, 16)).astype(np.int32)
    w[:n // 10] *= 40
    w[n // 10:n // 10 + 60] = 0
    mf = np.stack([jtables.QUANT4_MF[q % 6].reshape(16)[
        jtables.ZIGZAG4_FRAME] for q in qp]).astype(np.int64)
    shift = (15 + qp // 6)[:, None]
    lv = ((np.abs(w) * mf + (1 << shift) // 6) >> shift) * np.sign(w)
    return lv.astype(np.int32), w, qp


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["full", "ac", "dc_block"])
def test_trellis_4x4_matches_x264_tpu(kind, seed):
    lv, w, qp = _seeded_blocks(seed)
    assert (np.abs(lv) >= 15).sum() > 100 and (lv == 0).all(1).sum() >= 60
    kw = {"full": {}, "ac": {"b_ac": 1}, "dc_block": {"dc_block": True}}[kind]
    sig, last, lvl = jtrellis.frame_ctx_costs(False, 20 + 6 * seed, cat=2)
    ref_lv, ref_sc = jtrellis.trellis_4x4(
        jnp.asarray(lv), jnp.asarray(w), jnp.asarray(qp), jnp.asarray(sig),
        jnp.asarray(last), jnp.asarray(lvl), **kw)
    got_lv, got_sc = ttrellis.trellis_4x4(_t(lv), _t(w), _t(qp), sig, last,
                                          lvl, **kw)
    ref_lv = np.asarray(ref_lv)
    assert got_lv.dtype == torch.int32 and got_sc.dtype == torch.float32
    np.testing.assert_array_equal(ref_lv, got_lv.numpy())
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(ref_sc), rtol=1e-5,
                               atol=0)
    # the trellis did something: some blocks lost or lowered a level, and
    # with b_ac the DC position passes through untouched as zero
    assert (ref_lv != lv).any(1).sum() > 20
    if kind == "ac":
        assert not got_lv[:, 0].any()
    # an all-zero block stays empty at score 0
    zero = (lv == 0).all(1) & (w == 0).all(1)
    assert not got_lv.numpy()[zero].any()
    assert (got_sc.numpy()[zero] == 0).all()


def test_trellis_4x4_intra_lambda():
    """The twin cannot take `intra=True` (a traced flag picks its table),
    so the port's intra lambda is held against the table alone: intra
    scores are the inter ones at 0.65^2 / 0.85^2 of the rate term, so no
    score may rise and the levels may only move toward the deadzone ones."""
    lv, w, qp = _seeded_blocks(2, n=500)
    sig, last, lvl = ttrellis.frame_ctx_costs(False, 26, cat=2)
    lv_p, sc_p = ttrellis.trellis_4x4(_t(lv), _t(w), _t(qp), sig, last, lvl)
    lv_i, sc_i = ttrellis.trellis_4x4(_t(lv), _t(w), _t(qp), sig, last, lvl,
                                      intra=True)
    assert (sc_i <= sc_p).all() and (sc_i < sc_p).any()
    assert (lv_i.abs().sum(1) >= lv_p.abs().sum(1)).all()


# ---------------------------------------------------------------------- AQ
def _aq_planes(seed, mbw=6, mbh=5):
    """Noise whose amplitude changes per MB (so the energies spread over
    the AQ range), with one flat MB row (energy 0 -> the clamp to 1)."""
    rng = np.random.default_rng(seed)
    amp = rng.integers(1, 100, (mbh, mbw)).repeat(16, 0).repeat(16, 1)
    y = np.clip(128 + rng.normal(0, 1, amp.shape) * amp, 0, 255)
    ca = amp[::2, ::2]
    u = np.clip(128 + rng.normal(0, 1, ca.shape) * ca / 2, 0, 255)
    v = np.clip(128 + rng.normal(0, 1, ca.shape) * ca / 3, 0, 255)
    y[:16], u[:8], v[:8] = 7, 9, 200
    return [p.astype(np.uint8) for p in (y, u, v)]


@pytest.mark.parametrize("strength", [1.0, 0.6])
def test_aq_offsets_match_x264_tpu(strength):
    y, u, v = _aq_planes(4)
    ref = np.asarray(jaq.aq_offsets(jnp.asarray(y), jnp.asarray(u),
                                    jnp.asarray(v), strength))
    got = taq.aq_offsets(_t(y), _t(u), _t(v), strength)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-6)
    assert ref.max() - ref.min() > 4 * strength
    # the flat row: energy clamps to 1, log2 is 0
    np.testing.assert_allclose(got.numpy()[0],
                               np.float32(strength) * np.float32(-14.427),
                               rtol=0, atol=5e-6)


def _fake_enc(P, mbw, mbh, aq_on):
    """What build_qp_maps reads of an Encoder."""
    p = P.param_default_preset("medium")
    p.rc.aq_mode = P.AQ_VARIANCE if aq_on else P.AQ_NONE
    p.rc.aq_strength = 1.0
    p.rc.qp_min, p.rc.qp_max = 12, 40
    p.analyse.chroma_qp_offset = -2
    return types.SimpleNamespace(p=p, mb_w=mbw, mb_h=mbh)


@pytest.mark.parametrize("qp", [20, 36])
@pytest.mark.parametrize("case", ["aq", "aq+tree", "tree", "flat"])
def test_build_qp_maps_matches_x264_tpu(case, qp):
    """The AQ branch (offsets, round half to even, the clip to qp_min /
    qp_max, the chroma table with its offset), with and without the
    lookahead's tree_off, and the constant branch."""
    from x264_tpu import params as jp
    from x264_tpu_torch import params as tp
    mbw, mbh = 6, 5
    y, u, v = _aq_planes(5 + qp, mbw, mbh)
    rng = np.random.default_rng(9)
    tree = (rng.normal(0, 2, (mbh, mbw)).astype(np.float32)
            if "tree" in case else None)
    if tree is not None:
        tree[1, :3] = [0.5, 1.5, -2.5]       # ties of the round
    aq_on = "aq" in case
    ref = jfe.build_qp_maps(_fake_enc(jp, mbw, mbh, aq_on), jnp.asarray(y),
                            jnp.asarray(u), jnp.asarray(v), qp, tree)
    got = tfe.build_qp_maps(_fake_enc(tp, mbw, mbh, aq_on), _t(y), _t(u),
                            _t(v), qp, tree)
    for a, b in zip(ref, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if case != "flat":
        assert len(np.unique(got[0].numpy())) > 3
        assert got[0].min() >= 12 and got[0].max() <= 40
