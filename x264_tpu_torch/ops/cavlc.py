"""The CAVLC residual coder kernel (csrc/cavlc.cu), the port's form of
XLA's fusion of x264_tpu's residual_blocks_dev
(x264_tpu/entropy/cavlc_jax.py).

`cavlc_residual_launch` checks its tensors (device, dtype, shape,
contiguity) before it touches the library, allocates the outputs with
torch.empty, launches one kernel on the current stream, raises on a
non-zero return, and adds one to its `launches` count. It reads nothing
back and does not synchronise. The encoder reaches it through
`entropy/cavlc_dev.py` `residual_blocks_dev`, which sends CUDA tensors
here and CPU tensors to the plain version, `residual_blocks_plain`: the
kernel's specification.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ._cuda import check_tensor

_LIB = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_SLOTS = 36
MAX_COEFFS = 16


def _library():
    if "lib" not in _LIB:
        lib = _cuda.library()
        fn = lib.x264t_cavlc_residual
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        _LIB["lib"] = lib
    return _LIB["lib"]


def _device(t, name):
    """The CUDA device of `t`; raises for a tensor anywhere else."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"{name}: the CAVLC kernel takes CUDA tensors, got "
                         f"{where}")
    return t.device


def cavlc_residual_launch(coeffs, nc, chroma_dc: bool):
    """residual_blocks_plain's function in one launch: coeffs [B, L] int32
    zig-zag levels (1 <= L <= 16), nc [B] int32 (None with chroma_dc,
    whose class follows L). Returns (codes [B, 36] int64, lens [B, 36]
    int32, total [B] int32, over [B] bool)."""
    dev = _device(coeffs, "coeffs")
    if not isinstance(chroma_dc, bool):
        raise TypeError(f"chroma_dc: expected a bool, got {type(chroma_dc)}")
    B, L = coeffs.shape if coeffs.dim() == 2 else (0, 0)
    if not B or not 1 <= L <= MAX_COEFFS:
        raise ValueError(f"coeffs: shape {tuple(coeffs.shape)}, expected "
                         f"[B >= 1, 1 <= L <= {MAX_COEFFS}]")
    check_tensor(coeffs, "coeffs", (B, L), torch.int32, dev)
    if nc is not None or not chroma_dc:
        check_tensor(nc, "nc", (B,), torch.int32, dev)
    codes = torch.empty((B, BLOCK_SLOTS), dtype=torch.int64, device=dev)
    lens = torch.empty((B, BLOCK_SLOTS), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    over = torch.empty((B,), dtype=torch.bool, device=dev)
    rc = _library().x264t_cavlc_residual(
        coeffs.data_ptr(), None if nc is None else nc.data_ptr(), B, L,
        int(chroma_dc), codes.data_ptr(), lens.data_ptr(), total.data_ptr(),
        over.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cavlc_residual launch failed: CUDA error {rc}")
    cavlc_residual_launch.launches += 1
    return codes, lens, total, over


cavlc_residual_launch.launches = 0
