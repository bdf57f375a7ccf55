"""The viewer frame's direct path: one native call enqueues a frame.

``Renderer.render`` on the card runs the same kernels as
:func:`~voxtracer_torch.engine.pipeline.frame_stages`, but not through
their Python wrappers, each of which checks its inputs, allocates its
outputs and makes a ctypes call of its own every frame.  A
:class:`FramePlan`, built once for a renderer's configuration, runs
those checks once and holds what does not change from frame to frame
(the tables' and noise's pointers, the geometry block, the denoise
launch and its ``factor_dist`` table, the layout of a frame's outputs)
in one int64 block that ``csrc/frame.cu`` reads.  Per frame the host
packs the row, allocates one arena for all of the frame's outputs and
makes one native call (``vt_frame_launch``), which zeroes the counters
and calls the kernels' by-value entries with the arguments their
wrappers pass; the outputs and the new state are views of the arena.
Every frame gets new memory, so a state or image held from one frame is
never written by the next.

It engages (:func:`engages`) on a CUDA device; the CPU, the mesh and the
sequence and burst paths run the stages one by one.  A frame plan adds
to the wrappers' ``launches`` the kernels it enqueued
(:func:`frame_launches`), to ``COUNTS["denoise.resident_warps"]`` its
denoise launch's resident warps (asked once, when the plan is built),
to ``COUNTS["denoise.reciprocal_launches"]`` that launch where its range
quotient takes one correction, and to ``COUNTS["frames.direct"]`` the
frame.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..ops import denoise as denoise_op
from ..ops import epilogue as epilogue_op
from ..ops import trace as trace_op
from ..utils.timing import COUNTS, span
from . import pipeline
from .params import (
    ROW_DENOISE,
    ROW_FRAME,
    ROW_LEN,
    ROW_TEMPORAL,
    ROW_TRACE,
    _constant_row,
    fill_frame_row,
    old_basis_inverse,
)
from .scene import TABLES

# The plan block's int64 slots, in csrc/frame.cu `Slot` order: pointers
# (host: the row, the geometry, the factor_dist table), sizes, the row's
# slice offsets, the denoise launch (its range reciprocal as float32
# bits), the outputs' byte offsets in the arena and the counters' bytes.
SLOTS = (
    "row", "geometry", "packed", "meta", "brick", "palette", "noise",
    "n_slices", "height", "width", "radius", "device", "row_trace",
    "row_frame", "row_temporal", "row_denoise", "row_epilogue", "fdist",
    "dn_instance", "dn_block_x", "dn_block_y", "dn_rows", "dn_grid_x",
    "dn_grid_y", "dn_shared", "dn_recip", "dn_steps", "at_color",
    "at_normal", "at_albedo", "at_depth", "at_node", "at_counters",
    "at_blended", "at_next_blend", "at_image", "at_linear", "counter_bytes",
)
# each output's alignment in the arena (the kernels' vector paths need 16)
ALIGN = 256


def frame_launches(reproject: bool, radius: int) -> Tuple[str, ...]:
    """The kernels a frame launches, in order, as ``frame_stages``
    runs them: a still frame blends in the still epilogue (which at
    radius 0 also modulates and encodes), a reprojecting one in the
    temporal kernel; radius >= 1 denoises, and every frame but the still
    one at radius 0 ends in the encode.  ``csrc/frame.cu`` picks the
    same kernels from the same two values."""
    blend = "temporal" if reproject else "still_epilogue"
    if radius:
        return ("trace", blend, "denoise", "encode")
    return ("trace", blend, "encode") if reproject else ("trace", blend)


def engages(device: torch.device) -> bool:
    """Whether a renderer on ``device`` takes the direct path."""
    return device.type == "cuda"


def _stream(index: int) -> int:
    """The current stream of CUDA device ``index``, as a pointer."""
    return torch._C._cuda_getCurrentRawStream(index)


class FramePlan:
    """One renderer configuration's frames by the native call.

    ``key`` is what the plan was built for (``Renderer._frame_plan``
    builds another when it changes), ``lib`` the loaded kernel library,
    ``kernels`` the frame kernels' wrappers by stage (their
    ``launches`` count the frames' kernels).  The checks that the
    wrappers make at every launch run here once; a history that the plan
    did not write itself is checked once when it first comes in."""

    def __init__(self, key, lib, tables, noise: torch.Tensor, height: int,
                 width: int, radius: int, sigma_distance: float,
                 sigma_range: float, kernels: Dict[str, Callable]):
        trace_op._check_inputs(tables, noise, height, width)
        if not noise.is_contiguous():
            raise ValueError("noise must be contiguous")
        for name in TABLES:
            buf = getattr(tables, name)
            if buf.dtype != torch.int32 or not buf.is_contiguous():
                raise ValueError(f"{name} must be contiguous int32")
        if radius < 0:
            raise ValueError(f"denoise radius {radius} < 0")
        if lib.vt_frame_slots() != len(SLOTS):
            raise RuntimeError("the kernel library's frame plan has "
                               f"{lib.vt_frame_slots()} slots, not "
                               f"{len(SLOTS)}")
        self.key = key
        self.lib = lib
        self.launch = lib.vt_frame_launch
        self.tables, self.noise = tables, noise  # held: their pointers
        self.height, self.width, self.radius = height, width, radius
        self.device = tables.device
        self.index = -1 if self.device.index is None else self.device.index
        self.counted = {r: [kernels[s] for s in frame_launches(r, radius)]
                        for r in (False, True)}
        # host buffers the native call reads: held as long as the plan
        self.row = np.zeros(ROW_LEN, np.float32)
        self.geometry = tables.geometry()
        dn = denoise_op.tile_plan(height, width, radius) if radius else None
        self.fdist = (denoise_op.factor_dist_table(radius, sigma_distance)
                      if dn and dn.instance != denoise_op.GLOBAL_INSTANCE
                      else np.zeros(1, np.float32))
        rr = denoise_op.range_reciprocal(sigma_range) if dn else None
        # what each frame's denoise launch adds to its counters (the
        # native call passes no device row: the by-value entry)
        self.dn_warps = self.dn_reciprocal = 0
        if dn:
            with torch.cuda.device(self.index):
                self.dn_warps = denoise_op.resident_warps(
                    dn.instance, False, dn.shared_bytes, rr.steps)
            self.dn_reciprocal = denoise_op.reciprocal_launch(dn, rr)
        self._layout(height, width)
        slots = {
            "row": self.row.ctypes.data,
            "geometry": self.geometry.ctypes.data,
            **{name: getattr(tables, f"{name}_idx").data_ptr()
               for name in ("packed", "meta", "brick")},
            "palette": tables.palette.data_ptr(),
            "noise": noise.data_ptr(),
            "n_slices": int(noise.shape[0]),
            "height": height, "width": width, "radius": radius,
            "device": self.index,
            "row_trace": ROW_TRACE, "row_frame": ROW_FRAME,
            "row_temporal": ROW_TEMPORAL, "row_denoise": ROW_DENOISE,
            "row_epilogue": epilogue_op.ROW_EPILOGUE,
            "fdist": self.fdist.ctypes.data,
            "dn_instance": dn.instance if dn else 0,
            "dn_block_x": dn.block[0] if dn else 0,
            "dn_block_y": dn.block[1] if dn else 0,
            "dn_rows": dn.rows_per_thread if dn else 0,
            "dn_grid_x": dn.grid[0] if dn else 0,
            "dn_grid_y": dn.grid[1] if dn else 0,
            "dn_shared": dn.shared_bytes if dn else 0,
            "dn_recip": (int(np.float32(rr.y).view(np.uint32)) if dn
                         else 0),
            "dn_steps": rr.steps if dn else 0,
            **{f"at_{name}": at for name, at in self.at.items()},
            "counter_bytes": 8 * trace_op.N_COUNTERS,
        }
        self.block = np.array([slots[name] for name in SLOTS], np.int64)
        self.block_ptr = self.block.ctypes.data
        self._params = None  # (rp, tp, dp, their constant row)
        self._inverse = (None, None)  # (old camera's bytes, its inverse)
        self._history = (None, None)  # (planes written here, pointers)

    def _layout(self, h: int, w: int):
        """Each output's byte offset in the arena, ``ALIGN``-aligned, and
        the arena's bytes without and with the linear plane (last: the
        denoise kernel's output at radius >= 1, else only kept where the
        caller asks for it)."""
        plane, px = 4 * h * w, h * w
        sizes = (("color", 3 * plane), ("normal", 3 * plane),
                 ("albedo", 3 * plane), ("depth", plane), ("node", plane),
                 ("counters", 8 * trace_op.N_COUNTERS),
                 ("blended", 3 * plane), ("next_blend", plane),
                 ("image", 3 * px), ("linear", 3 * plane))
        self.at, end = {}, 0
        for name, size in sizes:
            self.at[name] = end
            end += -(-size // ALIGN) * ALIGN
        full = end
        lean = self.at["linear"]
        self.nbytes = {False: full if self.radius else lean, True: full}

    def pack(self, cam: np.ndarray, state, frame: int, rp, tp, dp):
        """The frame's row into ``self.row``, bit-equal to
        ``pack_frame_rows([cam], ...)[0]``: the parameter sets' constant
        row and the old camera's inverse are kept while they last."""
        params = self._params
        if (params is None or params[0] is not rp or params[1] is not tp
                or params[2] is not dp):
            params = self._params = (rp, tp, dp, _constant_row(rp, tp, dp))
        valid = state["history_valid"]
        old = np.asarray(state["old_cam"] if valid else cam, np.float32)
        tag = old.tobytes()
        if self._inverse[0] != tag:
            self._inverse = (tag, old_basis_inverse(old))
        fill_frame_row(self.row, cam, old, valid, frame, params[3],
                       self._inverse[1])

    def _history_pointers(self, planes) -> Tuple[int, int, int]:
        """The history planes' pointers, checked unless this plan wrote
        them."""
        known, pointers = self._history
        if known is not None and all(a is b for a, b in zip(planes, known)):
            return pointers
        h, w = self.height, self.width
        for name, t, shape in zip(
                ("accum_color", "accum_blend", "old_depth"), planes,
                ((3, h, w), (h, w), (h, w))):
            if (tuple(t.shape) != shape or t.dtype != torch.float32
                    or t.device != self.device or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be contiguous {shape} float32 on "
                    f"{self.device}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")
        return tuple(t.data_ptr() for t in planes)

    def render(self, state, cam: np.ndarray, reproject: bool, frame: int,
               rp, tp, dp, lean: bool):
        """One frame: ``(state, outputs)``, as ``render_frame`` returns
        them."""
        with span("vt.render.pack"):
            self.pack(cam, state, frame, rp, tp, dp)
        planes = (state["accum_color"], state["accum_blend"],
                  state["old_depth"])
        history = self._history_pointers(planes)
        keep = not lean
        with span("vt.render.launch"):
            arena = torch.empty(self.nbytes[keep], dtype=torch.uint8,
                                device=self.device)
            base = arena.data_ptr()
            err = self.launch(self.block_ptr, base, *history,
                              int(reproject), int(keep), _stream(self.index))
        if err != 0:
            raise RuntimeError(f"frame launch failed: cudaError {err}")
        for kernel in self.counted[reproject]:
            kernel.launches += 1
        COUNTS["denoise.resident_warps"] += self.dn_warps
        COUNTS["denoise.reciprocal_launches"] += self.dn_reciprocal
        COUNTS["frames.direct"] += 1
        return self._outputs(arena, base, cam, keep)

    def _outputs(self, arena, base: int, cam: np.ndarray, keep: bool):
        """The frame's ``(state, outputs)``: views of the arena, built by
        :func:`~voxtracer_torch.engine.pipeline.frame_outputs`; the image
        is the encode's contiguous (H, W, 3) bytes."""
        h, w, at = self.height, self.width, self.at
        f32 = arena.view(torch.float32)

        def planar(name):  # (3, h, w)
            return f32.as_strided((3, h, w), (h * w, w, 1), at[name] // 4)

        def flat(name, t=f32, size=4):  # (h, w)
            return t.as_strided((h, w), (w, 1), at[name] // size)

        blended, next_blend, depth = (planar("blended"), flat("next_blend"),
                                      flat("depth"))
        self._history = ((blended, next_blend, depth),
                         (base + at["blended"], base + at["next_blend"],
                          base + at["depth"]))
        gbuf = {"depth": depth,
                "rays": arena.view(torch.int64).as_strided(
                    (trace_op.N_PHASES,), (1,), at["counters"] // 8)}
        if keep:  # the planes a lean frame's outputs leave out
            gbuf.update({name: planar(name)
                         for name in ("color", "normal", "albedo")})
            gbuf["node"] = flat("node", arena.view(torch.int32))
        image = arena.as_strided((h, w, 3), (3 * w, 3, 1), at["image"])
        return pipeline.frame_outputs(
            cam, gbuf, blended, next_blend,
            planar("linear") if keep else None, image, not keep)
