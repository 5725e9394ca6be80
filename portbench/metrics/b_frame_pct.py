"""b_frame_pct: share of the traced window's output frames that are B
frames (the lookahead's slice-type decision)."""


def read(run):
    if not run["frames"]:
        return None
    return 100.0 * sum(f["type"] == "B" for f in run["frames"]) \
        / len(run["frames"])
