"""Presets faster, fast and slow through both Encoders at 64x48, each as
the preset sets it and nothing else changed but the size: CABAC, B
frames, MB-tree, two references (slow asks for 5; Encoder clamps to 2),
partitions, weightp; subme 4 and 6 run without the RD tier, slow's subme
8 with it (and trellis 2, direct auto). The port's bytes, frame types,
QPs and reconstructions equal x264_tpu's, its P-MB histogram too, and
tools/refdec.py decodes its stream to its reconstruction."""

import pytest
from test_inter_e2e import moving_frames
from torch_parity import assert_same_output, both, refdec_matches

from x264_tpu.encoder.encoder import TYPE_B, TYPE_IDR

W, H = 64, 48
PRESETS = ("faster", "fast", "slow")


@pytest.fixture(scope="module", params=list(PRESETS))
def clip(request):
    name = request.param

    def make(preset):
        p = preset(name)
        p.width, p.height = W, H
        return p
    run = both(make, moving_frames(5, W, H, seed=3))
    run["name"] = name
    return run


def test_preset_stream_matches_x264_tpu(clip):
    assert_same_output(clip)


def test_preset_mb_stats_match_x264_tpu(clip):
    ts, js = clip["enc"].stats, clip["jax_enc"].stats
    assert ts["mb"]["P"] == js["mb"]["P"]
    assert ts.get("weightp_frames") == js.get("weightp_frames")
    assert ts["mb"]["P"]["16x8"] + ts["mb"]["P"]["8x16"] > 0


def test_preset_frame_types(clip):
    types = [o.i_type for o in clip["got"][2]]
    assert types[0] == TYPE_IDR and TYPE_B in types
    assert clip["enc"].n_refs == 2 and clip["enc"].p.cabac


def test_refdec_decodes_preset_stream_to_its_recon(clip):
    assert all(refdec_matches(clip["got"][0], clip["got"][1]))
