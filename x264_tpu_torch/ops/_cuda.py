"""Build and load the port's hand-written CUDA kernels.

`nvcc` compiles every source of `SOURCES` (csrc/, sm_90a; one process per
source, all started together) and links them into one shared library with
a plain C interface, at first use, under
`_build/<hash of the sources>/`, and keeps ptxas's report (registers,
shared memory, spills) beside it as `build.log`. `library()` loads it once
per process; each op module declares the argument types of its own entry
points. The helpers below are shared by the kernels' wrappers: the
co-resident capacity of a persistent kernel, the checks of a wrapper's
tensors and of a persistent launch's progress words, and the two through
which the encoder's host reads the card's data and uploads its own
(`to_host`, `to_device`: each a traced host wait).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", name)
                for name in ("commit.cu", "deblock.cu", "motion.cu",
                             "cavlc.cu"))
BUILD = os.path.join(_PKG, "_build")
_LIB = {}
_LOCK = threading.Lock()


def _nvcc():
    exe = shutil.which("nvcc")
    if exe is None:
        cand = "/usr/local/cuda/bin/nvcc"
        exe = cand if os.path.exists(cand) else None
    if exe is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return exe


def build_library() -> str:
    """Compile SOURCES for sm_90a into _build/<source hash>/ (once per
    version of the sources) and return the library path: one nvcc per
    source, all started together, then one link. Raises on failure."""
    digest = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, "libx264t_kernels.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = _nvcc(), f".tmp{os.getpid()}"
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}{tag}.o")
            for src in SOURCES]
    jobs = [subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC", "-c", "-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs = [job.communicate()[0] for job in jobs]
    link = None
    if all(job.returncode == 0 for job in jobs):
        link = subprocess.run([nvcc, "-gencode",
                               "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", lib + tag, *objs],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                           + "\n".join(logs))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(logs))      # ptxas: registers, shared memory
    os.replace(lib + tag, lib)
    return lib


def library():
    """The kernels' library, built if needed and loaded once."""
    with _LOCK:
        if "lib" not in _LIB:
            _LIB["lib"] = ctypes.CDLL(build_library())
        return _LIB["lib"]


def capacity(kernel: str, device) -> int:
    """Blocks of the persistent kernel `kernel` ("commit", "deblock") that
    `device` holds at once, from the library's x264t_<kernel>_capacity()
    (cached per device)."""
    key = (kernel, torch.device(device).index)
    with _LOCK:
        if key in _LIB:
            return _LIB[key]
    fn = getattr(library(), f"x264t_{kernel}_capacity")
    fn.restype, fn.argtypes = ctypes.c_int, []
    with torch.cuda.device(device):
        n = fn()
    if n <= 0:
        raise RuntimeError(f"{kernel} kernel occupancy query failed: CUDA "
                           f"error {-n}")
    with _LOCK:
        _LIB[key] = n
    return n


def check_tensor(t, name, shape, dtype, device):
    """Raise unless `t` is a contiguous tensor of this shape and dtype on
    `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_progress(prog, done):
    """Raise unless the persistent launch that filled `prog` (each MB
    row's progress word, then the error word) finished every row: each
    word reached `done` (mbw finished MBs for the commit kernel, 2 mbw
    half-steps for the deblock kernel). Synchronises with the launch."""
    p = to_host(prog, "kernel_progress")
    if int(p[-1]) != 0:
        raise RuntimeError("kernel: a wavefront wait ran past its bound; the "
                           "frame is incomplete")
    if int(p[:-1].min()) != done:
        raise RuntimeError("kernel: MB rows left unfinished")


def to_host(t, site):
    """`t.cpu()`: on a CUDA tensor the host waits for the card. Traced as
    a "sync:<site>" span and one `host_syncs` of the current frame
    (utils/trace.py), on any device, so that a CPU run counts the waits a
    run on the card makes."""
    with trace.waits(site):
        return t.cpu()


def to_device(a, device, site, dtype=None):
    """`torch.as_tensor(a, dtype, device)`. Host data (numpy, a Python
    number or list, a CPU tensor) is a blocking copy, which on a CUDA
    device waits for it: traced as `to_host` is. A tensor already on
    `device` is neither copied nor traced."""
    dev = torch.device(device)
    if (isinstance(a, torch.Tensor) and a.device.type == dev.type
            and dev.index in (None, a.device.index)):
        return torch.as_tensor(a, dtype=dtype)
    with trace.waits(site):
        return torch.as_tensor(a, dtype=dtype, device=dev)
