"""entropy_ms_per_frame: self time of the entropy layer's spans (device
CAVLC, trellis, decision packing, the CABAC writer, slice finalisers;
synchronised host clock) over the first half of the traced window, per
frame output in it."""


def read(run):
    if run["spans"] is None or not run["spanned_frames"]:
        return None
    return run["spans"].layer_ms("entropy") / run["spanned_frames"]
