"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``voxtracer_torch/csrc/*.cu`` export plain C entry
points (no PyTorch headers).  One ``nvcc -c`` per source, all started
together, then one link build them in seconds into a shared library
that ``ctypes`` loads.  The library is cached under
``voxtracer_torch/build/`` by a hash of the sources and flags, and is
built at first use — never at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import time

from ..utils.timing import COUNTS

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
# -fmad=false: no FMA contraction, so the kernels round every operation
# as the plain torch versions do (no --use_fast_math either: IEEE
# division and square root).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    with ptxas's register and spill report for every kernel.  The first
    source that fails stops the build at once (a hot-reload waits for
    it)."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    srcs = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in srcs]
        # each compiler's output goes to a file: a pipe nobody reads
        # while another source compiles could fill and stall it
        logs = [obj + ".log" for obj in objs]
        procs = []
        for src, obj, log_path in zip(srcs, objs, logs):
            with open(log_path, "w") as f:
                # a session of its own: stopping it stops nvcc's cicc
                # and ptxas too
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))
        pending = set(range(len(procs)))
        try:
            while pending:
                done = [i for i in pending if procs[i].poll() is not None]
                for i in done:
                    pending.discard(i)
                    if procs[i].returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {os.path.basename(srcs[i])} "
                            f"({procs[i].returncode}):\n{_read(logs[i])}")
                if not done:
                    time.sleep(0.02)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except ProcessLookupError:  # it ended meanwhile
                        pass
                proc.wait()
        log = [_read(log_path) for log_path in logs]
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib, *objs], capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}"
            )
        with open(out + ".log", "w") as f:
            f.write("".join(log))
        os.replace(lib, out)
    return out


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def build_log() -> str:
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every entry
    point's C signature.  Counted in ``kernel.builds``: it runs again
    only after a hot-reload clears its cache."""
    lib = ctypes.CDLL(build())
    COUNTS["kernel.builds"] += 1
    p, i = ctypes.c_void_p, ctypes.c_int
    # Each frame kernel takes its parameters by value (params, a host
    # pointer) or, where that is null (for the denoise: besides it), from
    # its slice of a frame row on the device (row).  Null optional
    # pointers (albedo, linear, slot) leave their part out.
    # vt_trace_launch(params, row, geometry, packed, meta, brick, palette,
    #   noise, n_slices, frame, height, width, row0, row_stride, color,
    #   normal, albedo, depth, node, counters, stream) -> cudaError_t
    lib.vt_trace_launch.argtypes = [p] * 8 + [i] * 6 + [p] * 6 + [p]
    lib.vt_trace_launch.restype = ctypes.c_int
    # vt_trace_steps_launch(params, geometry, packed, meta, brick, palette,
    #   noise, n_slices, frame, height, width, row0, row_stride, color,
    #   normal, albedo, depth, node, counters, steps_map, stream)
    lib.vt_trace_steps_launch.argtypes = [p] * 7 + [i] * 6 + [p] * 8
    lib.vt_trace_steps_launch.restype = ctypes.c_int
    # vt_trace_info(out[5])
    lib.vt_trace_info.argtypes = [p]
    lib.vt_trace_info.restype = ctypes.c_int
    # vt_temporal_launch(params, row, color, normal, depth, old_color,
    #   old_blend, old_depth, height, width, row0, img_height, blended,
    #   next_blend, stream) -> cudaError_t
    lib.vt_temporal_launch.argtypes = [p] * 8 + [i] * 4 + [p] * 3
    lib.vt_temporal_launch.restype = ctypes.c_int
    # vt_denoise_launch(params, fdist, row, colors, normal, depth, albedo,
    #   node, height, width, row0, radius, instance, block_x, block_y,
    #   rows, grid_x, grid_y, shared, recip, steps, out, stream)
    #   -> cudaError_t
    f, u = ctypes.c_float, ctypes.c_uint
    lib.vt_denoise_launch.argtypes = [p] * 8 + [i] * 11 + [f, i] + [p] * 2
    lib.vt_denoise_launch.restype = ctypes.c_int
    # vt_denoise_resident_warps(instance, row, steps, shared) -> warps an
    #   SM, or minus the cudaError
    lib.vt_denoise_resident_warps.argtypes = [i] * 4
    lib.vt_denoise_resident_warps.restype = ctypes.c_int
    # vt_denoise_quotient_check(sigma_range, recip, steps, first, count,
    #   out, stream) -> cudaError_t
    lib.vt_denoise_quotient_check.argtypes = [f, f, i, u, u, p, p]
    lib.vt_denoise_quotient_check.restype = ctypes.c_int
    # vt_resample_launch(hist, px_f, py_f, channels, height, width,
    #   sampled, ok, stream) -> cudaError_t
    lib.vt_resample_launch.argtypes = [p] * 3 + [i] * 3 + [p] * 3
    lib.vt_resample_launch.restype = ctypes.c_int
    # vt_stall_launch(tab, x, trips, mode, h, pre, mid, out, cycles,
    #   stream) -> cudaError_t
    lib.vt_stall_launch.argtypes = [p] * 2 + [i] * 5 + [p] * 3
    lib.vt_stall_launch.restype = ctypes.c_int
    # vt_still_epilogue_launch(params, row, color, normal, depth,
    #   old_color, old_blend, old_depth, albedo, height, width, row0,
    #   blended, next_blend, linear, image, slot, n_images, in_place,
    #   stream) -> cudaError_t
    lib.vt_still_epilogue_launch.argtypes = [p] * 9 + [i] * 3 + [p] * 5 + [
        i, i, p]
    lib.vt_still_epilogue_launch.restype = ctypes.c_int
    # vt_encode_launch(params, row, src, albedo, in_h, in_w, height, width,
    #   linear, image, slot, n_images, stream) -> cudaError_t
    lib.vt_encode_launch.argtypes = [p] * 4 + [i] * 4 + [p] * 3 + [i, p]
    lib.vt_encode_launch.restype = ctypes.c_int
    # vt_frame_launch(plan, arena, old_color, old_blend, old_depth,
    #   reproject, keep_linear, stream) -> cudaError_t (engine/direct.py)
    lib.vt_frame_launch.argtypes = [p] * 5 + [i, i, p]
    lib.vt_frame_launch.restype = ctypes.c_int
    lib.vt_frame_slots.argtypes = []
    lib.vt_frame_slots.restype = ctypes.c_int
    return lib
