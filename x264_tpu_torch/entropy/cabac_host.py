"""Host CABAC writer: ctypes bridge to the C++ engine (csrc/cabac.cpp).

A copy of x264_tpu/entropy/cabac_host.py, with its own copy of the C++
source. The engine implements the normative H.264 clause 9.3.4 encoding
process (spec figures 9-7..9-12). The device computes decisions and
residuals as tensors; this module ships them to the serial C++ bit
engine. g++ builds the shared library at first use into
x264_tpu_torch/_build/, keyed by the hash of the source; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils import trace
from . import cabac_tables as T

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "cabac.cpp")
_BUILD = os.path.join(_PKG_DIR, "_build")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD, f"libcabac-{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        r = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("g++ failed building the CABAC writer:\n"
                               + r.stdout + r.stderr)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    lib.cabac_encode_slice.restype = ctypes.c_int
    lib.cabac_encode_slice.argtypes = [
        u8, u8, u8, u8, u8,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8, u8, u8, u8, u8, u8, u8, u8, i8, u8, u8,
        u8, ctypes.c_int,
        i16, i16, i16, i16, i16, i16,
        u8, ctypes.c_int]
    _lib = lib
    return lib


def init_states(slice_type_i: bool, qp: int, model: int = 0):
    """Initial context variables per spec 9.3.1.1: preCtxState =
    Clip3(1, 126, ((m * SliceQPY) >> 4) + n); pStateIdx/valMPS split at
    64. Returns (pStateIdx[1024], valMPS[1024]) as uint8."""
    tab = T.CTX_INIT_I if slice_type_i else T.CTX_INIT_PB[model]
    m = tab[:, 0].astype(np.int32)
    n = tab[:, 1].astype(np.int32)
    pre = np.clip(((m * np.clip(qp, 0, 51)) >> 4) + n, 1, 126)
    mps = (pre > 63).astype(np.uint8)
    pstate = np.where(pre > 63, pre - 64, 63 - pre).astype(np.uint8)
    return pstate, mps


_LPS_FLAT = np.ascontiguousarray(T.RANGE_TAB_LPS.reshape(-1))
_TRANS_MPS = np.ascontiguousarray(T.TRANS_IDX_MPS)
_TRANS_LPS = np.ascontiguousarray(T.TRANS_IDX_LPS)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


@trace.spanned("entropy:cabac_writer")
def encode_slice_cabac(slice_type, mbw: int, mbh: int,
                       slice_qp: int, skip, is_intra, i16_mode,
                       chroma_mode, cbp_luma, cbp_chroma, qp_mb, mvd,
                       luma_dc, luma_ac, chroma_dc, chroma_ac,
                       model: int = 0, bmode=None, mvd1=None,
                       part_mode=None, is_i4=None, i4_modes=None,
                       refidx=None, n_refs: int = 1) -> bytes:
    """Write one slice's CABAC mb layer. Residual arrays are zigzagged;
    luma blocks in z-scan coding order. Returns the payload bytes
    (cabac-aligned slice data, to append after the slice header)."""
    lib = _load()
    n = mbw * mbh
    # slice_type: True/2 = I, False/0 = P, 1 = B (I uses the I init
    # table; P and B share the PB tables, selected by cabac_init_idc)
    st = 2 if slice_type is True else 0 if slice_type is False \
        else int(slice_type)
    pstate, mps = init_states(st == 2, slice_qp, model)

    def u8c(a):
        return np.ascontiguousarray(np.asarray(a, np.uint8).reshape(-1))

    def i16c(a, shape):
        out = np.ascontiguousarray(np.asarray(a, np.int16).reshape(-1))
        assert out.size == shape, (out.size, shape)
        return out

    skip = u8c(skip)
    is_intra = u8c(is_intra)
    is_i4 = u8c(is_i4 if is_i4 is not None else np.zeros(n))
    i4_modes = u8c(i4_modes if i4_modes is not None
                   else np.zeros((n, 16)))
    i16_mode = u8c(i16_mode)
    chroma_mode = u8c(chroma_mode)
    cbp_luma = u8c(cbp_luma)
    cbp_chroma = u8c(cbp_chroma)
    qp_mb = np.ascontiguousarray(np.asarray(qp_mb, np.int8).reshape(-1))
    mvd = i16c(mvd, n * 2)
    bmode = u8c(bmode if bmode is not None else np.zeros(n))
    part_mode = u8c(part_mode if part_mode is not None else np.zeros(n))
    refidx = u8c(refidx if refidx is not None else np.zeros(n))
    mvd1 = i16c(mvd1 if mvd1 is not None else np.zeros((n, 2)), n * 2)
    luma_dc = i16c(luma_dc, n * 16)
    luma_ac = i16c(luma_ac, n * 256)
    chroma_dc = i16c(chroma_dc, n * 8)
    chroma_ac = i16c(chroma_ac, n * 128)

    cap = max(65536, n * 1024)
    out = np.empty(cap, np.uint8)
    rc = lib.cabac_encode_slice(
        _ptr(pstate, ctypes.c_uint8),
        _ptr(mps, ctypes.c_uint8),
        _ptr(_LPS_FLAT, ctypes.c_uint8),
        _ptr(_TRANS_MPS, ctypes.c_uint8),
        _ptr(_TRANS_LPS, ctypes.c_uint8),
        st, mbw, mbh, slice_qp,
        _ptr(skip, ctypes.c_uint8), _ptr(is_intra, ctypes.c_uint8),
        _ptr(is_i4, ctypes.c_uint8), _ptr(i4_modes, ctypes.c_uint8),
        _ptr(i16_mode, ctypes.c_uint8), _ptr(chroma_mode, ctypes.c_uint8),
        _ptr(cbp_luma, ctypes.c_uint8), _ptr(cbp_chroma, ctypes.c_uint8),
        _ptr(qp_mb, ctypes.c_int8), _ptr(bmode, ctypes.c_uint8),
        _ptr(part_mode, ctypes.c_uint8),
        _ptr(refidx, ctypes.c_uint8), int(n_refs),
        _ptr(mvd, ctypes.c_int16), _ptr(mvd1, ctypes.c_int16),
        _ptr(luma_dc, ctypes.c_int16), _ptr(luma_ac, ctypes.c_int16),
        _ptr(chroma_dc, ctypes.c_int16), _ptr(chroma_ac, ctypes.c_int16),
        _ptr(out, ctypes.c_uint8), cap)
    if rc < 0:
        raise RuntimeError("CABAC output buffer overflow")
    return out[:rc].tobytes()
