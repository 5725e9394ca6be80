"""x264_tpu_torch: the x264-tpu encoder ported to PyTorch and CUDA.

A second package beside `x264_tpu` (the JAX reference). Each module mirrors
its `x264_tpu` counterpart's path and is held against it bit for bit. The
port imports `torch` and nothing of `x264_tpu` or `jax`: the host modules
it needs (params, NAL/SPS/PPS/SEI and slice-header writers, VLC and quant
tables, rate control) are copies kept at the same relative paths.

Device handling: every entry point takes an explicit `device`; a tensor's
device decides where its work runs (a CUDA tensor reaches the hand-written
kernels, a CPU tensor their plain PyTorch versions).
"""

__version__ = "0.1.0"    # x264_tpu's; the version SEI carries it

from .params import param_default_preset, param_parse  # noqa: F401,E402
