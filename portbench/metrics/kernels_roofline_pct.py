"""kernels_roofline_pct: over the launches of the port's hand-written
kernels in the profiled stretch, the sum of each launch's bound
(roofline.py, on that launch's own inputs) over the sum of their device
times (torch.profiler). Nothing when no launch was seen, when the
launches and the kernels do not line up, or when the card is not in
roofline.PEAKS."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr["launches"]:
        return None
    if any(b is None for _, _, b in tr["launches"]):
        return None
    dev = sum(d for _, d, _ in tr["launches"])
    return 100.0 * sum(b for _, _, b in tr["launches"]) / dev
