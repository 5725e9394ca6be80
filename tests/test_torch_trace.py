"""The port's tracer (x264_tpu_torch/utils/trace.py) on one 48x32 clip
through `Encoder` at the medium configuration's options (CRF 23, CABAC,
2 references, adaptive B frames, MB-tree, AQ, trellis, subme 7; a 4-frame
lookahead for the short clip), which codes I, P and B frames: the stream
and the reconstructions are the same with the tracer on and off, nothing
is recorded while it is off, every span nests inside its frame's
`encoder:encode` span, the layers' self times and the host's waits make
up the encode spans' time, and `host_syncs` counts one per `sync:` span
on every frame."""

import numpy as np
import pytest
import torch

from x264_tpu_torch.encoder.encoder import TYPE_B, Encoder, Picture
from x264_tpu_torch.params import param_default_preset, param_parse
from x264_tpu_torch.utils import trace

W, H, N = 48, 32, 4
LAYERS = ("encoder", "lookahead", "analysis", "entropy", "sync")


def clip(n=N, seed=5):
    """A static textured background with sensor noise and one block
    moving half a pixel a frame: the adaptive decision picks B frames."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(40, 200, (H, W)).astype(np.int16)
    frames = []
    for i in range(n):
        y = bg + rng.integers(-1, 2, (H, W))
        x0 = 8 + i // 2
        y[16:32, x0:x0 + 16] = 120 + (np.arange(16) * 5)[None, :]
        u = np.full((H // 2, W // 2), 128 + i % 3, np.uint8)
        frames.append([np.clip(y, 0, 255).astype(np.uint8), u, u.copy()])
    return frames


def params():
    p = param_default_preset("medium", None)
    for k, v in (("crf", "23"), ("ref", "2"), ("rc-lookahead", "4")):
        param_parse(p, k, v)
    p.width, p.height = W, H
    return p


def encode(frames):
    enc = Encoder(params(), device="cpu")
    outs = []
    for i, f in enumerate(frames + [None] * 8):
        nals, out = enc.encode(None if f is None else Picture(f, pts=i))
        if out is not None:
            outs.append((b"".join(n.payload for n in nals), out.i_type,
                         [np.asarray(r).copy() for r in out.recon]))
    return outs


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        frames = clip()
        trace.start()
        stale = trace.stop()
        off = encode(frames)
        trace.start()
        try:
            on = encode(frames)
        finally:
            rec = trace.stop()
        return off, on, rec, stale
    finally:
        torch.set_num_threads(threads)


def test_outputs_are_the_same_on_and_off(runs):
    off, on, _, _ = runs
    assert {t for _, t, _ in off} >= {1, 3, TYPE_B}, [t for _, t, _ in off]
    assert len(on) == len(off) == N
    for (b0, t0, r0), (b1, t1, r1) in zip(off, on):
        assert (b0, t0) == (b1, t1)
        for a, b in zip(r0, r1):
            np.testing.assert_array_equal(a, b)


def test_nothing_is_recorded_while_off(runs):
    _, _, rec, stale = runs
    assert stale.spans == [] and stale.counters == {}
    assert len(stale.clock) == 2
    assert trace.current() is None
    with trace.span("encoder:encode"):
        trace.count("host_syncs")
    assert stale.spans == [] and stale.counters == {}
    assert rec.spans and rec.counters


def test_every_span_nests_inside_its_frames_encode_span(runs):
    spans = runs[2].spans
    roots = [s for s in spans if s[3] < 0]
    assert roots and all(s[0] == "encoder:encode" for s in roots)
    assert len(roots) == N + 8
    for s in spans:
        assert s[1] <= s[2]
        if s[3] < 0:
            continue
        parent = spans[s[3]]
        assert parent[1] <= s[1] and s[2] <= parent[2], (s, parent)
        root = s
        while root[3] >= 0:
            root = spans[root[3]]
        assert root[1] <= s[1] and s[2] <= root[2]
        assert s[0].split(":", 1)[0] in LAYERS, s[0]
        # a span takes its parent's frame unless it names its own
        if s[0] not in ("encoder:enqueue", "encoder:finalize"):
            assert s[4] == parent[4], (s, parent)


def test_self_times_and_waits_make_up_the_encode_spans(runs):
    spans = runs[2].spans
    child = [0] * len(spans)
    for s in spans:
        if s[3] >= 0:
            child[s[3]] += s[2] - s[1]
    by_layer = dict.fromkeys(LAYERS, 0)
    for s, c in zip(spans, child):
        by_layer[s[0].split(":", 1)[0]] += s[2] - s[1] - c
    total = sum(s[2] - s[1] for s in spans if s[3] < 0)
    assert all(v >= 0 for v in by_layer.values()), by_layer
    assert sum(by_layer.values()) == pytest.approx(total, rel=0.01)
    assert by_layer["analysis"] > 0 and by_layer["sync"] > 0


def test_host_syncs_count_the_sync_spans_of_every_frame(runs):
    rec = runs[2]
    frames = {s[4] for s in rec.spans if s[4] is not None}
    assert frames == set(range(N))
    per_frame = {}
    for s in rec.spans:
        if s[0].startswith("sync:"):
            per_frame[s[4]] = per_frame.get(s[4], 0) + 1
    counted = {f: n for (f, name), n in rec.counters.items()
               if name == "host_syncs"}
    assert counted == per_frame
    assert all(counted.get(f, 0) > 0 for f in frames)
