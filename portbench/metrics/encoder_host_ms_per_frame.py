"""encoder_host_ms_per_frame: self time of the program's `encoder:*` spans
(Encoder.encode, intake, rate control, enqueue, finalize; unsynchronised,
x264_tpu_torch/utils/trace.py) over the program stretch that follows a
traced window, per frame output in it (portbench/progtrace.py)."""

from portbench import progtrace


def read(run):
    r = progtrace.stretch(run)
    return None if r is None else r["host_ms_per_frame"]["encoder"]
