"""lookahead_ms_per_frame: self time of the lookahead layer's spans
(encoder/lookahead.py; synchronised host clock) over the first half of
the traced window, per frame output in it."""


def read(run):
    if run["spans"] is None or not run["spanned_frames"]:
        return None
    return run["spans"].layer_ms("lookahead") / run["spanned_frames"]
