"""analysis_host_ms_per_frame: self time of the program's `analysis:*`
spans (dispatch, motion, intra, RD, transform, commit, deblock, the
B-frame stages), unsynchronised (x264_tpu_torch/utils/trace.py), over the
program stretch that follows a traced window, per frame output in it; the
host's waits inside them are `sync:` spans and are left out
(portbench/progtrace.py)."""

from portbench import progtrace


def read(run):
    r = progtrace.stretch(run)
    return None if r is None else r["host_ms_per_frame"]["analysis"]
