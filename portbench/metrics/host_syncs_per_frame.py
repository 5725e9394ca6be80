"""host_syncs_per_frame: the program's `host_syncs` counter (one per
blocking copy to or from the card, or read of its data, on the encode
path; x264_tpu_torch/utils/trace.py) over the program stretch that
follows a traced window, per frame output in it
(portbench/progtrace.py)."""

from portbench import progtrace


def read(run):
    r = progtrace.stretch(run)
    return None if r is None else r["host_syncs_per_frame"]
