"""The plain CAVLC residual coder (entropy/cavlc_dev.py
residual_blocks_plain, the CPU path and the specification of the kernel
csrc/cavlc.cu) against x264_tpu's residual_blocks_dev (jax.jit, CPU) on
every case of tests/cavlc_cases.py, one batch per block length; the card
holds the kernel against the plain version on the same cases
(tests/test_torch_cavlc.py, which imports no JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cavlc_cases import cavlc_cases
from x264_tpu.entropy import cavlc_jax
from x264_tpu_torch.entropy import cavlc_dev

CASES = cavlc_cases()
GROUPS = {"l16": (16, False), "l15": (15, False), "chroma_dc_2x2": (4, True),
          "chroma_dc_2x4": (8, True)}


@pytest.mark.parametrize("group", list(GROUPS))
def test_plain_path_matches_x264_tpu(group):
    """residual_blocks_plain against x264_tpu's residual_blocks_dev
    (jax.jit, CPU) on every case of the group's block length, in one batch:
    codes, lengths, total and over."""
    L, chroma_dc = GROUPS[group]
    names = [n for n in sorted(CASES) if CASES[n][0].shape[1] == L
             and CASES[n][2] == chroma_dc]
    coeffs = np.concatenate([CASES[n][0] for n in names])
    nc = np.concatenate([CASES[n][1] for n in names])
    ref = jax.jit(cavlc_jax.residual_blocks_dev,
                  static_argnames=("chroma_dc",))(
        jnp.asarray(coeffs), jnp.asarray(nc), chroma_dc=chroma_dc)
    got = cavlc_dev.residual_blocks_plain(torch.from_numpy(coeffs),
                                          torch.from_numpy(nc), chroma_dc)
    assert int(np.asarray(ref[3]).sum()) == int(got[3].sum())
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy().astype(np.int64),
                                      err_msg=f"{group} ({names}): output {i}")
    if group in ("l16", "l15"):
        assert got[3].any(), "no case sets over"
