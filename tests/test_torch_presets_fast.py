"""The three fastest presets through both Encoders at 64x48, each as the
preset sets it and nothing else changed but the size: ultrafast (CAVLC,
no B frames, one reference, no deblock, no I_4x4, no partitions, subme 0,
no weightp, no AQ, no lookahead, no scene cut), superfast (CABAC, B
frames, partitions off: its a.inter holds intra flags only, as x264_tpu
has it; subme 1, weightp) and veryfast (CABAC, B frames, MB-tree, one
reference, partitions without the RD tier, subme 2). The port's bytes,
frame types, QPs and reconstructions equal x264_tpu's, its P-MB histogram
too, and tools/refdec.py decodes its stream to its reconstruction."""

import pytest
from test_inter_e2e import moving_frames
from torch_parity import assert_same_output, both, refdec_matches

from x264_tpu.encoder.encoder import TYPE_B, TYPE_IDR, TYPE_P

W, H = 64, 48
PRESETS = ("ultrafast", "superfast", "veryfast")
N_FRAMES = 5          # I P B P P where the preset has B frames


@pytest.fixture(scope="module", params=list(PRESETS))
def clip(request):
    name = request.param

    def make(preset):
        p = preset(name)
        p.width, p.height = W, H
        return p
    run = both(make, moving_frames(N_FRAMES, W, H, seed=3))
    run["name"] = name
    return run


def test_preset_stream_matches_x264_tpu(clip):
    assert_same_output(clip)


def test_preset_mb_stats_match_x264_tpu(clip):
    """The P-MB histogram; each preset takes the branch it was chosen
    for."""
    ts, js = clip["enc"].stats, clip["jax_enc"].stats
    assert ts["mb"]["P"] == js["mb"]["P"]
    assert ts.get("weightp_frames") == js.get("weightp_frames")
    mb = ts["mb"]["P"]
    if clip["name"] in ("ultrafast", "superfast"):
        assert mb["16x8"] + mb["8x16"] + mb["8x8"] == 0
    else:
        assert mb["16x8"] + mb["8x16"] > 0


def test_preset_frame_types(clip):
    types = [o.i_type for o in clip["got"][2]]
    assert types[0] == TYPE_IDR and TYPE_P in types
    assert (TYPE_B in types) == (clip["name"] != "ultrafast")
    assert clip["enc"].p.cabac == (clip["name"] != "ultrafast")


def test_refdec_decodes_preset_stream_to_its_recon(clip):
    assert all(refdec_matches(clip["got"][0], clip["got"][1]))
