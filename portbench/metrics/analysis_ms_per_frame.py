"""analysis_ms_per_frame: self time of the frame-analysis layer's spans
(encoder/frame_encode.py, inter.py, bframe.py, intra.py stage functions;
synchronised host clock) over the first half of the traced window, per
frame output in it."""


def read(run):
    if run["spans"] is None or not run["spanned_frames"]:
        return None
    return run["spans"].layer_ms("analysis") / run["spanned_frames"]
