"""kbps: 8 x the Annex-B bytes (start codes included) of every NAL unit of
the Q quality frames (Q consecutive frames in display order from the
first frame output in the window) / 1000, over their duration at the
clip's declared frame rate."""


def read(run):
    q = run["quality"]
    return 8 * q["bytes"] / 1000 / (q["frames"] / q["fps_declared"])
