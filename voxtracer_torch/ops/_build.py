"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``voxtracer_torch/csrc/*.cu`` export plain C entry
points (no PyTorch headers), so one ``nvcc`` call builds them in
seconds into a shared library that ``ctypes`` loads.  The library is
cached under ``voxtracer_torch/build/`` by a hash of the sources and
flags, and is built at first use — never at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
# -fmad=false: no FMA contraction, so the kernels round every operation
# as the plain torch versions do (no --use_fast_math either: IEEE
# division and square root).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvoxtracer_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is not built yet; returns
    the library path.  ``build_log`` (next to it) keeps nvcc's output,
    with ptxas's register and spill report for every kernel."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_log() -> str:
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every entry
    point's C signature."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    # vt_trace_launch(params, geometry, packed, meta, brick, palette,
    #   noise, n_slices, frame, height, width, color, normal, albedo,
    #   depth, node, rays, stream) -> cudaError_t
    lib.vt_trace_launch.argtypes = [p] * 7 + [i] * 4 + [p] * 6 + [p]
    lib.vt_trace_launch.restype = ctypes.c_int
    # vt_temporal_launch(params, color, normal, depth, old_color,
    #   old_blend, old_depth, height, width, blended, next_blend,
    #   stream) -> cudaError_t
    lib.vt_temporal_launch.argtypes = [p] * 7 + [i] * 2 + [p] * 3
    lib.vt_temporal_launch.restype = ctypes.c_int
    # vt_denoise_launch(params, colors, normal, depth, albedo, node,
    #   height, width, radius, out, stream) -> cudaError_t
    lib.vt_denoise_launch.argtypes = [p] * 6 + [i] * 3 + [p] * 2
    lib.vt_denoise_launch.restype = ctypes.c_int
    # vt_resample_launch(hist, px_f, py_f, channels, height, width,
    #   sampled, ok, stream) -> cudaError_t
    lib.vt_resample_launch.argtypes = [p] * 3 + [i] * 3 + [p] * 3
    lib.vt_resample_launch.restype = ctypes.c_int
    # vt_stall_launch(tab, x, trips, mode, h, pre, mid, out, cycles,
    #   stream) -> cudaError_t
    lib.vt_stall_launch.argtypes = [p] * 2 + [i] * 5 + [p] * 3
    lib.vt_stall_launch.restype = ctypes.c_int
    return lib
