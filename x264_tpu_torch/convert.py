"""State carried across the two packages.

An encoder has no weights. What it carries is its parameters (each
package has its own `params.Params`, field for field the same) and its
device state, the DPB: a list of entry dicts with the reference planes
{"y_pad", "hpel", "cuv_pad"}, the picture's {"frame_num", "poc", "tag"} and
the co-located fields a P frame leaves for a later B frame {"mvf" [mbh,
mbw, 2], "mvf4" [mbh*4, mbw*4, 2], "inter_mask" [mbh, mbw]} (an I frame
leaves no "mvf4"). These helpers move one entry between numpy (and so JAX)
and torch, so both encoders can start from the same reference state.
"""

from __future__ import annotations

import numpy as np
import torch

def dpb_entry_from_numpy(entry: dict, device) -> dict:
    """DPB entry with array values (numpy or anything np.asarray takes) ->
    the same entry with torch tensors on `device`; scalars pass through."""
    out = {}
    for k, v in entry.items():
        if isinstance(v, (int, float, str, type(None))):
            out[k] = v
        else:
            out[k] = torch.from_numpy(np.array(v)).to(device)
    return out


def dpb_entry_to_numpy(entry: dict) -> dict:
    """DPB entry with torch tensors -> the same entry with numpy arrays."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in entry.items()}
