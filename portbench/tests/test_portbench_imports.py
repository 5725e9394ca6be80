"""What the benchmark loads, what BENCHMARK.json names, and the clip.

Module names are compared by their top-level name (the part before the
first dot) as a whole: x264_tpu_torch begins with x264_tpu and is not
x264_tpu."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BANNED = {"jax", "jaxlib", "flax", "x264_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def top_level_after(code):
    """Top-level names in sys.modules of a fresh process after `code`."""
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_x264_tpu():
    names = top_level_after(
        "import sys; sys.argv = ['run.py']\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "import entry\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'tiny_medium.tiny', '--seed', '7',"
        " '--seconds', '1', '--trace', '1', '--device', 'cpu']"
        " + entry.REHEARSAL)\n"
        "assert rc == 0, rc")
    assert "x264_tpu_torch" in names          # the program ran
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_encoders():
    names = top_level_after(
        "from portbench import check\n"
        "from portbench.reference import decoder")
    assert not names & (BANNED | {"x264_tpu_torch", "torch"}), names


def test_harness_sources_name_no_banned_module():
    """No file of the benchmark imports a banned module by name."""
    pat = re.compile(r"^\s*(?:from|import)\s+(\w+)", re.M)
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    mods = set(pat.findall(fh.read()))
                assert not mods & BANNED, (f, mods & BANNED)


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for key in ("end_to_end", "per_layer"):
        for x in m[key]:
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher")
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert [x["name"] for x in m["end_to_end"]] == ["fps", "kbps",
                                                    "psnr_y_db", "setup_s"]
    for x in m["end_to_end"]:
        assert set(x) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= x["bound"] <= 0.25
    # a full check: 2 + 14 x cells runs, each run_seconds + 60, 2 x 90 s
    # of compile a cell and 1,200 s spare, for 24 cells
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_cell_resolves_to_its_files():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    used = set()
    for w in m["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        for path in (c["file"],
                     f"portbench/traffic/{w['traffic']}.json",
                     f"portbench/cells/{w['name']}.json"):
            with open(os.path.join(ROOT, path)) as f:
                json.load(f)
    assert used == set(configs)


def test_per_layer_metrics_name_a_layer_move_fps_and_have_a_reader():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["layer"] and "\n" not in x["layer"]
        assert x["moves"] == "fps"
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(x.get("workloads", cells)) <= cells
    for x in m["end_to_end"] + m["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           x["name"] + ".py"))


def test_the_seed_makes_the_clip():
    from portbench.clipgen import make_clip
    with open(os.path.join(ROOT, "portbench", "traffic", "sports.json")) as f:
        mix = dict(json.load(f), frames=6)
    a = make_clip(mix, 96, 64, 2 ** 31 + 11, "cpu")
    b = make_clip(mix, 96, 64, 2 ** 31 + 11, "cpu")
    c = make_clip(mix, 96, 64, 2 ** 31 + 12, "cpu")
    assert all(np.array_equal(x, y) for f, g in zip(a, b)
               for x, y in zip(f, g))
    assert not np.array_equal(a[3][0], c[3][0])
    assert [p.shape for p in a[0]] == [(64, 96), (32, 48), (32, 48)]


@pytest.mark.parametrize("mix", ["sports", "talking_head"])
def test_every_mix_is_data_for_the_generator(mix):
    from portbench.clipgen import make_clip
    with open(os.path.join(ROOT, "portbench", "traffic", mix + ".json")) as f:
        frames = make_clip(dict(json.load(f), frames=3), 128, 96, 5, "cpu")
    assert len(frames) == 3 and frames[2][0].dtype == np.uint8
