"""psnr_y_db: luma PSNR of the Q quality frames' reconstructions
(PicOut.recon; Q consecutive frames in display order from the first frame
output in the window) against the source the benchmark made, from their
summed squared error (x264's "global" PSNR)."""

import math


def read(run):
    q = run["quality"]
    if q["sse_y"] == 0:
        return None
    return 10 * math.log10(255.0 ** 2 * q["pixels_y"] / q["sse_y"])
