"""Per-MB window gather (x264_tpu/ops/warp.py `mb_windows_ref`).

x264_tpu keeps two one-hot matmul forms of this gather for the TPU, whose
gathers are slow, and picks one per platform (`mb_windows_auto`). A GPU
gathers directly, so the port has the gather alone, and calls it wherever
x264_tpu calls `mb_windows_auto`.
"""

from __future__ import annotations

import torch


def mb_windows_ref(planes, off, *, bs: int, win: int, pad: int):
    """planes [P, Hp, Wp] (padded by `pad` on every side); off [..., mbh,
    mbw, 2] (x, y) window offsets. Returns the [..., mbh, mbw, P, win, win]
    windows whose top-left corner sits at each block's origin plus its
    offset, in the planes' dtype.

    The callers' motion ranges keep every index inside the padded planes;
    a row or column index that strays is clamped to the plane's edge, per
    dimension, as the motion kernels clamp it. x264_tpu's jnp indexing
    clamps an index past the far edge alike but wraps a negative one, so
    the two differ only on windows that no search reaches."""
    P, Hp, Wp = planes.shape
    mbh = (Hp - 2 * pad) // bs
    mbw = (Wp - 2 * pad) // bs
    dev = planes.device
    off = off.to(torch.int64)
    base_y = (torch.arange(mbh, device=dev) * bs)[:, None] + pad + off[..., 1]
    base_x = (torch.arange(mbw, device=dev) * bs)[None, :] + pad + off[..., 0]
    ar = torch.arange(win, device=dev)
    rows = (base_y[..., None, None] + ar[:, None]).clamp(0, Hp - 1)
    cols = (base_x[..., None, None] + ar).clamp(0, Wp - 1)
    idx = rows * Wp + cols                            # [..., mbh, mbw, w, w]
    flat = planes.reshape(P, Hp * Wp)
    out = flat[:, idx.reshape(-1)].reshape((P,) + idx.shape)
    return out.movedim(0, -3)
