"""frame_latency_ms_p95: 95th percentile of the time from a frame's
encode call to the return of the call that handed back its NAL units
(host clock), over the frames that went in during the traced window's
second half, where no span synchronises the calls. Needs 20 frames or
more (nearest rank)."""

import math


def read(run):
    lat = sorted((f["t_out"] - f["t_in"]) * 1e3 for f in run["frames"]
                 if f["t_in"] >= run["clean_from"])
    if len(lat) < 20:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
