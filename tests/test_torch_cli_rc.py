"""The rate-control paths that only the command line reaches, through the
port's CLI and x264_tpu's on the CPU, tolerance 0 (48x32, 8 frames, preset
medium): ABR with VBV, `--nal-hrd cbr` (buffering-period and pic-timing
SEIs) and filler; `--aud`; two passes through a stats file. Bytes equal,
and the stats files too."""

import numpy as np
import pytest

from x264_tpu.encoder import ratecontrol as jrc
from x264_tpu.params import param_default_preset as jax_preset
from x264_tpu_torch.encoder import ratecontrol as trc
from x264_tpu_torch.entropy.nal import NAL_AUD, NAL_FILLER, NAL_SEI
from x264_tpu_torch.params import RC_ABR, param_default_preset
from torch_parity import cli_both, cli_run, write_clip

# a rate above what the clip needs, so that CBR pads with filler
VBV = ["--bitrate", "1000", "--vbv-maxrate", "1000", "--vbv-bufsize", "200",
       "--nal-hrd", "cbr", "--filler"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_rc")
    write_clip(tmp / "in.y4m")
    return tmp


def nal_types(stream):
    """NAL unit types of an Annex-B stream, in order."""
    b = np.frombuffer(stream, np.uint8)
    starts = np.flatnonzero((b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1))
    return [int(b[s + 3]) & 31 for s in starts]


@pytest.mark.parametrize("name,extra,must_have", [
    ("vbv_hrd_filler", VBV, {NAL_SEI, NAL_FILLER}),
    ("aud", ["--aud"], {NAL_AUD})])
def test_cli_rate_control_writes_the_same_bytes(clip, name, extra,
                                                must_have):
    got = cli_both(clip, name, "264", extra)
    assert got["port"][0] == got["jax"][0] == 0
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    assert must_have <= set(nal_types(got["port"][1]))


def test_cli_two_pass_writes_the_same_bytes_and_stats(clip):
    """Pass 1 writes the stats file, pass 2 reads it. Neither encoder
    writes an MB-tree file: x264_tpu's Encoder never calls
    RateControl.mbtree_record (ROADMAP section 3, F8), nor does the
    port's."""
    stats = {}
    for n in (1, 2):
        got = {}
        for side in ("jax", "port"):
            st = clip / f"stats_{side}.log"
            opts = ["--bitrate", "200", "--pass", str(n), "--stats", str(st)]
            got[side] = cli_run(side, clip, f"pass{n}", "264", opts)
            stats[side] = st.read_text()
            assert not (clip / f"stats_{side}.log.mbtree").exists()
        assert got["port"][0] == got["jax"][0] == 0
        assert got["port"][1] == got["jax"][1], f"pass {n}"
        assert got["port"][2] == got["jax"][2], f"pass {n}"
        assert stats["port"] == stats["jax"]
        assert len(stats["port"].splitlines()) >= 8


def test_mbtree_file_round_trip_alike(tmp_path):
    """RateControl's MB-tree file (the pass-1 record, the pass-2 fetch)
    writes the same bytes and reads back the same offsets on both
    sides."""
    rng = np.random.default_rng(0)
    offs = [rng.normal(0, 1.5, (2, 3)).astype(np.float32) for _ in range(3)]
    data, back = {}, {}
    for side, rc_mod, preset in (("jax", jrc, jax_preset),
                                 ("port", trc, param_default_preset)):
        stats = str(tmp_path / f"{side}.stats")

        def params(**rc):
            p = preset("medium")
            p.width, p.height = 48, 32
            p.rc.rc_method = RC_ABR
            p.rc.bitrate = 300
            p.rc.qp_max = 51
            for k, v in rc.items():
                setattr(p.rc, k, v)
            return p

        rc1 = rc_mod.RateControl(params(stat_write=True, stat_out=stats))
        for i, o in enumerate(offs):
            rc1.mbtree_record(i, o)
            rc1.start(3)
            rc1.end(3, 9000, 40000.0, 26)
        rc1.write_stats()
        with open(stats + ".mbtree", "rb") as f:
            data[side] = f.read()
        rc2 = rc_mod.RateControl(params(stat_read=True, stat_in=stats))
        back[side] = [rc2.mbtree_fetch(i) for i in range(3)]
    assert data["port"] == data["jax"]
    for a, b in zip(back["jax"], back["port"]):
        np.testing.assert_array_equal(a, b)
