"""fps: frames whose NAL units encode calls of the window returned, over
the window's seconds (host clock; the window ends when the call running
at its deadline returns)."""


def read(run):
    return len(run["frames"]) / run["window_s"]
