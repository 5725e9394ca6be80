"""Constant tables: scan orders, quant scales, chroma QP map.

These are H.264 spec tables (ITU-T Rec. H.264 tables 8-13..8-15, normAdjust
matrices, zig-zag scans). Reference keeps them in common/tables.c +
common/set.c:31-71.

The port's own copy of `x264_tpu/ops/tables.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

import numpy as np

# --- quantization scale tables (spec normAdjust4x4/8x8) --------------------
# class order: [both-even, one-odd, both-odd] i.e. class = (r&1)+(c&1)
DEQUANT4_SCALE = np.array([
    [10, 13, 16],
    [11, 14, 18],
    [13, 16, 20],
    [14, 18, 23],
    [16, 20, 25],
    [18, 23, 29],
], dtype=np.int32)

QUANT4_SCALE = np.array([
    [13107, 8066, 5243],
    [11916, 7490, 4660],
    [10082, 6554, 4194],
    [9362, 5825, 3647],
    [8192, 5243, 3355],
    [7282, 4559, 2893],
], dtype=np.int32)

# 8x8 position -> class, indexed by (r&3)*4 + (c&3)
QUANT8_CLASS = np.array(
    [0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1], dtype=np.int32)

DEQUANT8_SCALE = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)

QUANT8_SCALE = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int32)


def quant4_class_map() -> np.ndarray:
    """[4,4] -> class index 0..2."""
    r = np.arange(4)[:, None]
    c = np.arange(4)[None, :]
    return ((r & 1) + (c & 1)).astype(np.int32)


def quant8_class_map() -> np.ndarray:
    """[8,8] -> class index 0..5."""
    r = np.arange(8)[:, None] & 3
    c = np.arange(8)[None, :] & 3
    return QUANT8_CLASS[(r * 4 + c).astype(np.int32)]


# per-(qp%6) [4,4] / [8,8] matrices
DEQUANT4_MF = DEQUANT4_SCALE[:, quant4_class_map()]      # [6,4,4]
QUANT4_MF = QUANT4_SCALE[:, quant4_class_map()]          # [6,4,4]
DEQUANT8_MF = DEQUANT8_SCALE[:, quant8_class_map()]      # [6,8,8]
QUANT8_MF = QUANT8_SCALE[:, quant8_class_map()]          # [6,8,8]

# --- scans (spec tables 8-12/8-13, frame coding) ---------------------------
# zig-zag scan of a 4x4 block: scan[k] = raster index of k-th coeff
ZIGZAG4_FRAME = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32)

ZIGZAG8_FRAME = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# field (interlaced) scans, for later MBAFF support
ZIGZAG4_FIELD = np.array(
    [0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15], dtype=np.int32)

# --- chroma QP mapping (spec table 8-15) ------------------------------------
CHROMA_QP_TABLE = np.array(
    [i for i in range(30)] +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
     38, 39, 39, 39, 39], dtype=np.int32)


def chroma_qp(qp_y: int | np.ndarray, chroma_qp_offset: int = 0,
              qp_bd_offset: int = 0):
    """Map luma QP to chroma QP."""
    q = np.clip(np.asarray(qp_y) + chroma_qp_offset, -qp_bd_offset, 51)
    return np.where(q < 0, q, CHROMA_QP_TABLE[np.maximum(q, 0)])


# raster offsets of the 16 4x4 luma blocks within a MB, in coding order
# (z-scan: 4 8x8 quadrants, each 4 4x4 blocks)
LUMA4x4_SCAN_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
LUMA4x4_SCAN_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
