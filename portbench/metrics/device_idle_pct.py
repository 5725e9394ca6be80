"""device_idle_pct: share of the profiled stretch of the window in which
no operation ran on the card (torch.profiler; an upper bound, as the
profiler slows the host)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0 or not tr["n_ops"]:
        return None
    return 100.0 * (1 - tr["busy_s"] / tr["window_s"])
