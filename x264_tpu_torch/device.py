"""Device selection and small constant tensors.

Nothing here picks a device on its own: callers name one, and asking for
CUDA where there is none raises instead of falling back to the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


@functools.cache
def _const_cached(key: bytes, shape: tuple, dtype: str,
                  device: torch.device) -> torch.Tensor:
    from .ops._cuda import to_device
    arr = np.frombuffer(key, dtype=dtype).reshape(shape)
    return to_device(arr.copy(), device, "const_table")


def const(arr, device, dtype=torch.int32) -> torch.Tensor:
    """A small numpy table as a (cached, read-only by convention) tensor on
    `device`, uploaded once per (table, device)."""
    a = np.ascontiguousarray(np.asarray(arr).astype(
        torch.empty((), dtype=dtype).numpy().dtype))
    return _const_cached(a.tobytes(), a.shape, a.dtype.str,
                         torch.device(device))
