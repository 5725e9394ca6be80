"""Error resilience through both Encoders at 64x48 (the configuration of
tests/test_recovery.py: preset medium, IPPP, CQP 26, CAVLC, no scene
cut), held against x264_tpu byte for byte and in reconstruction:

- periodic intra refresh at keyint 4: after the IDR every frame is P, a
  column band sweeps the frame each keyint, each restart is a keyframe
  with a recovery-point SEI; refdec decodes the port's stream to its
  reconstruction;
- Encoder.intra_refresh() under PIR (keyint 6) queues a sweep restart
  before the natural one; without PIR (one reference) it makes the next
  frame an IDR;
- Encoder.invalidate_reference(2) once 3 frames are dispatched, with one
  reference (the survivor falls outside the decoder's one-frame window:
  the next frame is an IDR, and refdec decodes every frame) and with two
  (the next frame references the surviving frame 1). The second case
  reproduces a fault of x264_tpu (ROADMAP section 3): its DPB entries
  carry the frame_num of the frame after them, so the frame after the
  invalidation signals no ref_pic_list_modification and both decoders
  reconstruct frames 3-6 from other references than the encoder used.
  The port's bytes equal x264_tpu's; refdec agrees up to frame 2 and
  differs from frame 3 on."""

import numpy as np
import pytest
from test_inter_e2e import moving_frames
from torch_parity import assert_same_output, both, ippp, refdec_matches

from x264_tpu.encoder.encoder import TYPE_IDR, TYPE_P

W, H = 64, 48


def _refresh_at_3(enc, i):
    if i == 3:
        enc.intra_refresh()


def _invalidate_after_3(enc, i):
    # frame i - 2 is the newest dispatched one (lookahead window 2, no
    # pipe): before frame 4 the DPB holds frames 1 and 2
    if i == 4:
        enc.invalidated = enc.invalidate_reference(2)


CASES = {
    "pir": (dict(intra_refresh=True, keyint_max=4), 10, None),
    "pir_refresh": (dict(intra_refresh=True, keyint_max=6), 8,
                    _refresh_at_3),
    "refresh_idr": (dict(frame_reference=1), 6, _refresh_at_3),
    "invalidate_1ref": (dict(frame_reference=1), 7, _invalidate_after_3),
    "invalidate_2ref": ({}, 7, _invalidate_after_3),
}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    over, n, before = CASES[request.param]
    r = both(lambda preset: ippp(preset, **over),
             moving_frames(n, W, H, seed=7), before)
    r["name"] = request.param
    return r


def test_recovery_stream_matches_x264_tpu(run):
    assert_same_output(run)
    assert run["enc"].stats["mb"]["P"] == run["jax_enc"].stats["mb"]["P"]


def test_recovery_frame_types_and_keyframes(run):
    outs = run["got"][2]
    types = [o.i_type for o in outs]
    keys = [o.b_keyframe for o in outs]
    name = run["name"]
    if name == "pir":
        assert types == [TYPE_IDR] + [TYPE_P] * 9
        assert keys == [i % 4 == 0 for i in range(10)]
        assert run["got"][0].count(b"\x00\x00\x01\x06") \
            > run["got"][0].count(b"\x00\x00\x01\x06", 0, 40)
    elif name == "pir_refresh":
        assert types == [TYPE_IDR] + [TYPE_P] * 7
        assert any(keys[1:6]), keys
    elif name == "refresh_idr":
        assert types.count(TYPE_IDR) == 2 and types[0] == TYPE_IDR
    else:
        assert run["enc"].invalidated == run["jax_enc"].invalidated == 0
        want_idr = name == "invalidate_1ref"
        assert (TYPE_IDR in types[1:]) == want_idr


def test_refdec_decodes_recovery_stream(run):
    ok = refdec_matches(run["got"][0], run["got"][1])
    if run["name"] == "invalidate_2ref":
        # the reference's fault, reproduced (see the module docstring)
        assert ok == [True] * 3 + [False] * 4
        assert ok == refdec_matches(run["ref"][0], run["ref"][1])
    else:
        assert all(ok)


def test_dpb_frame_nums_match_x264_tpu(run):
    """The DPB entries' frame_num, poc and tag (the frame_num one ahead,
    as in x264_tpu), and the PIR sweep state."""
    keys = ("frame_num", "poc", "tag")
    assert ([[e[k] for k in keys] for e in run["enc"]._dpb]
            == [[e[k] for k in keys] for e in run["jax_enc"]._dpb])
    assert run["enc"]._pir_state == run["jax_enc"]._pir_state
    assert np.array_equal(run["got"][1][-1][0], run["ref"][1][-1][0])
