"""sync_wait_ms_per_frame: the total of the program's `sync:<site>` spans
(x264_tpu_torch/ops/_cuda.py to_host / to_device and the traced waits
of utils/trace.py): the time the host was blocked on the card, over the
program stretch that follows a traced window, per frame output in it
(portbench/progtrace.py)."""

from portbench import progtrace


def read(run):
    r = progtrace.stretch(run)
    return None if r is None else r["sync_wait_ms_per_frame"]
