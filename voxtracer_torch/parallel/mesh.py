"""Row-slab rendering over a list of devices: the port's mesh.

Counterpart of :mod:`voxtracer.parallel.mesh` and of the ``shard_map``
branch of ``voxtracer.engine.pipeline.render_frame_impl``
(``pipeline.py:230-413``), in one process over a tuple of
``torch.device``.  The image's rows are cut into slabs, one a device of
the mesh (a device may appear several times: ``["cuda:0"] * n`` holds n
slabs on one card).  The scene tables and the noise buffer are
replicated once per distinct device (:func:`scene_device_args`); the
frame's per-pixel planes and the carried state live per slab, on the
slab's device.  A frame runs every stage slab by slab, each stage on its
slab's rows alone:

1. trace: each slab traces its own image rows (``ops/trace.py``
   ``render_sample(..., row0, row_stride)``: ray generation and noise
   rows read the image row);
2. temporal: a still frame blends each slab with its own history rows
   (the still epilogue, ``row0``); a reprojecting frame gathers the whole
   history onto each distinct device and blends each slab against it
   (``temporal_blend_reproject(..., row0)``): the history is read at any
   offset, as the JAX package's all-gather branch (``pipeline.py:294-326``)
   and not its fixed halos;
3. denoise (r >= 1): each slab's window, the slab and up to r rows of its
   neighbours above and below (``min(r, row0)`` and ``min(r, H - row0 -
   h)``), is denoised with the window's first row as ``row0``; the slab's
   rows of the result tap nothing beyond the window, and at the image's
   edge the window's edge is the image's, so the zero padding matches;
4. encode: each slab's rows (at r >= 1 the window's, then cropped).

Neighbour rows (the denoise windows, the whole history, the cyclic
resort) move as slices copied to the destination slab's device, on that
device's current stream (``Tensor.to``): a device-to-device copy where the
two devices differ, none where they are one.  A halo taller than a slab
is taken from as many slabs as it spans (the reference relays it hop by
hop, ``pipeline.py:83-91``).  Everything is bit-equal to the one-device
frame (``engine/pipeline.py`` ``render_frame``): every stage computes a
pixel from the same inputs in the same operations.

Slabs are ``ceil(H / n)`` rows, the last one shorter (the reference
raises unless n divides H, ``mesh.py:84-87``); a height that leaves a
slab empty is refused.  ``layout="cyclic"`` balances the trace, whose
cost follows the image's content: device c traces every n-th band of
:data:`~voxtracer_torch.ops.trace.BLOCK_ROWS` rows from band c on, in one
launch (``row_stride = n``), and :func:`cyclic_to_contig` resorts the
G-buffer into the contiguous slabs the other stages run on.  Where n
bands do not divide H, each device traces only its bands' rows inside
the image: nothing is padded, cropped or refused (the reference raises
at 720p, 1080p and 4K, ``pipeline.py:246-250``).  The reference skips
its ``debug_iters`` plane in the resort (``pipeline.py:284``); the port
has no such plane, and every plane it has is resorted.

Left out, by decision: the reference's ``resample`` switch and its
fast-motion predictor (the port always gathers history at any offset),
``trace_knobs`` (TPU tiling), and ``torch.distributed``: one process
drives every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.params import (
    DENOISE_PARAMS_LEN,
    ROW_DENOISE,
    ROW_FRAME,
    ROW_TEMPORAL,
    ROW_TRACE,
    TEMPORAL_PARAMS_LEN,
    TRACE_PARAMS_LEN,
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_frame_rows,
)
from ..engine.pipeline import STATE_PLANES, camera_moved
from ..engine.scene import GridScene, SceneTables
from ..ops import denoise as denoise_op
from ..ops import epilogue as epilogue_op
from ..ops import temporal as temporal_op
from ..ops import trace as trace_op
from ..ops.noise import blue_noise_buffer
from ..ops.trace import BLOCK_ROWS

Mesh = Tuple[torch.device, ...]
LAYOUTS = ("contiguous", "cyclic")
# the trace's per-pixel planes, which the cyclic layout resorts
GBUF_PLANES = ("color", "normal", "depth", "albedo", "node")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh's devices, one slab each: by default every CUDA device
    (raises where there is none); ``["cpu"] * n`` or ``["cuda:0"] * n``
    hold n slabs on one device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "(e.g. ['cpu'] * n)")
        devices = [f"cuda:{i}" for i in range(n)]
    mesh = tuple(_device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


def scene_device_args(
    scene: GridScene, mesh: Mesh, noise_buffer: Optional[np.ndarray] = None
) -> Tuple[Tuple[SceneTables, ...], Tuple[torch.Tensor, ...]]:
    """The scene tables and the (S, 128, 128) noise buffer (blue noise
    unless given) of each slab: one copy per distinct device, which its
    slabs share."""
    if noise_buffer is None:
        noise_buffer = blue_noise_buffer()
    noise = torch.from_numpy(np.ascontiguousarray(noise_buffer, np.float32))
    tables: Dict[torch.device, SceneTables] = {}
    noises: Dict[torch.device, torch.Tensor] = {}
    for d in mesh:
        if d not in tables:
            tables[d] = SceneTables(scene, d)
            noises[d] = noise.to(d)
    return (tuple(tables[d] for d in mesh), tuple(noises[d] for d in mesh))


def slab_bounds(height: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """The contiguous slabs' image rows ``[start, end)``: ``ceil(H / n)``
    rows each, the last one shorter.  Raises where a slab is empty."""
    rows = -(-height // n)
    bounds = tuple((min(i * rows, height), min((i + 1) * rows, height))
                   for i in range(n))
    if height < 1 or bounds[-1][1] <= bounds[-1][0]:
        raise ValueError(f"height {height} leaves a slab of {n} empty "
                         f"({rows} rows a slab)")
    return bounds


def cyclic_heights(height: int, n: int) -> Tuple[int, ...]:
    """The rows device c traces in the cyclic layout: those of its bands
    c, c + n, c + 2n, ... (``BLOCK_ROWS`` rows each) inside the image.
    Raises where a device would trace none."""
    block = BLOCK_ROWS
    n_bands = -(-height // block)
    heights = tuple(
        sum(min(block, height - b * block) for b in range(c, n_bands, n))
        for c in range(n))
    if min(heights) < 1:
        raise ValueError(f"height {height} gives a device of {n} no band of "
                         f"{block} rows")
    return heights


def cyclic_plan(mesh: Mesh, height: int):
    """Where each contiguous slab's rows lie in the cyclic layout: for
    destination slab s, ``{source device c: (local, at)}``, int64 index
    tensors of the rows in c's traced planes (on c's device) and of
    their places in the slab (on s's device); pairs without rows left
    out.  Made once a mesh and height: no frame copies an index."""
    n, block = len(mesh), BLOCK_ROWS
    plan = []
    for (start, end), dev in zip(slab_bounds(height, n), mesh):
        g = np.arange(start, end, dtype=np.int64)
        src = (g // block) % n
        local = (g // (block * n)) * block + g % block
        plan.append({
            int(c): (torch.from_numpy(local[src == c]).to(mesh[c]),
                     torch.from_numpy((g - start)[src == c]).to(dev))
            for c in np.unique(src)})
    return plan


class CopyCount:
    """The row blocks copied to assemble denoise windows, whole
    histories and resorted slabs since :meth:`reset` (a slab's own rows
    included): all of them, those that crossed between distinct devices
    (``peer``), and their bytes."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.copies = self.peer = self.bytes = 0

    def move(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``t`` on ``device``, counted as one block copied."""
        self.copies += 1
        self.bytes += t.numel() * t.element_size()
        if t.device != device:
            self.peer += 1
        return t.to(device)


def cyclic_to_contig(traced: Sequence[torch.Tensor], mesh: Mesh, height: int,
                     plan, count: CopyCount):
    """Resort one plane of the cyclic layout (device c's traced rows, on
    axis -2, from ``traced[c]``) into the contiguous slabs, each on its
    slab's device, by :func:`cyclic_plan`'s ``plan``.  Counterpart of
    the reference's ``_cyclic_to_contig`` (``pipeline.py:94``)."""
    ref = traced[0]
    out = []
    for (start, end), dev, parts in zip(slab_bounds(height, len(mesh)), mesh,
                                        plan):
        slab = torch.empty(ref.shape[:-2] + (end - start, ref.shape[-1]),
                           dtype=ref.dtype, device=dev)
        for c, (local, at) in parts.items():
            rows = traced[c].index_select(-2, local)
            slab.index_copy_(-2, at, count.move(rows, dev))
        out.append(slab)
    return out


def gather_rows(slabs: Sequence[torch.Tensor], bounds, start: int, end: int,
                device: torch.device, count: CopyCount) -> torch.Tensor:
    """Image rows ``[start, end)`` of a plane held as contiguous slabs
    (rows on axis -2), as one contiguous tensor on ``device``: the
    slices of every slab they span, moved there."""
    parts = [count.move(t.narrow(-2, max(start, s) - s,
                                 min(end, e) - max(start, s)), device)
             for t, (s, e) in zip(slabs, bounds) if s < end and start < e]
    return torch.cat(parts, dim=-2)


def shard_state(state: Dict, mesh: Mesh, height: int) -> Dict:
    """A one-device state (``engine.pipeline.init_state`` /
    ``state_from_numpy``) as the mesh's: each plane's slab rows copied
    onto the slab's device."""
    bounds = slab_bounds(height, len(mesh))
    out = {
        k: tuple(
            state[k].narrow(-2, s, e - s).to(
                d, copy=True, memory_format=torch.contiguous_format)
            for (s, e), d in zip(bounds, mesh))
        for k in STATE_PLANES
    }
    out["old_cam"] = np.array(state["old_cam"], np.float32)
    out["history_valid"] = bool(state["history_valid"])
    return out


def gather_state(state: Dict, device) -> Dict:
    """The mesh's state as one device's (the slabs' rows concatenated on
    ``device``): for comparisons and snapshots."""
    dev = _device(device)
    out = {k: torch.cat([t.to(dev) for t in state[k]], dim=-2)
           for k in STATE_PLANES}
    out["old_cam"] = np.array(state["old_cam"], np.float32)
    out["history_valid"] = bool(state["history_valid"])
    return out


class SlabFrame:
    """One frame over the mesh's slabs; see :func:`sharded_render_frame`.
    ``count`` counts the row blocks it copies (:class:`CopyCount`)."""

    def __init__(self, mesh: Mesh, height: int, width: int, radius: int,
                 layout: str):
        self.mesh, self.height, self.width = mesh, height, width
        self.radius, self.layout = radius, layout
        self.bounds = slab_bounds(height, len(mesh))
        if layout == "cyclic":
            self.traced = cyclic_heights(height, len(mesh))
            self.plan = cyclic_plan(mesh, height)
        self.count = CopyCount()

    def _trace(self, tables, noise, params, frame):
        n, w = len(self.mesh), self.width
        if self.layout == "contiguous":
            return [trace_op.render_sample(tables[i], params, noise[i], frame,
                                           e - s, w, row0=s)
                    for i, (s, e) in enumerate(self.bounds)]
        traced = [trace_op.render_sample(tables[c], params, noise[c], frame,
                                         self.traced[c], w,
                                         row0=c * BLOCK_ROWS, row_stride=n)
                  for c in range(n)]
        planes = {k: cyclic_to_contig([t[k] for t in traced], self.mesh,
                                      self.height, self.plan, self.count)
                  for k in GBUF_PLANES}
        # the ray counters are per launch; the frame sums them
        return [{**{k: planes[k][i] for k in GBUF_PLANES},
                 "rays": traced[i]["rays"]} for i in range(n)]

    def __call__(
        self,
        state: Dict,
        tables: Sequence[SceneTables],
        noise: Sequence[torch.Tensor],
        cam: np.ndarray,
        render_params: RenderParams,
        temporal_params: TemporalParams,
        denoise_params: DenoiseParams,
        frame_number: int,
        lean: bool = False,
    ):
        mesh, bounds, radius = self.mesh, self.bounds, self.radius
        h_img, w = self.height, self.width
        row = pack_frame_rows(
            [cam], state["old_cam"], state["history_valid"], frame_number,
            render_params, temporal_params, denoise_params,
        )[0]
        trace_p = row[ROW_TRACE:ROW_TRACE + TRACE_PARAMS_LEN]
        temporal_p = row[ROW_TEMPORAL:ROW_TEMPORAL + TEMPORAL_PARAMS_LEN]
        denoise_p = row[ROW_DENOISE:ROW_DENOISE + DENOISE_PARAMS_LEN]
        frame = int(row[ROW_FRAME:ROW_FRAME + 1].view(np.int32)[0])
        reproject = state["history_valid"] and camera_moved(state, cam)
        keep_linear = not lean

        gbufs = self._trace(tables, noise, trace_p, frame)
        history = [tuple(state[k][i] for k in STATE_PLANES)
                   for i in range(len(mesh))]
        if reproject:
            # the whole history, once per distinct device
            whole = {}
            for d in mesh:
                if d not in whole:
                    whole[d] = tuple(
                        gather_rows(state[k], bounds, 0, h_img, d, self.count)
                        for k in STATE_PLANES)
        blended, next_blend, outs, images = [], [], [], []
        for i, ((s, e), g) in enumerate(zip(bounds, gbufs)):
            planes = (g["color"], g["normal"], g["depth"])
            if reproject:
                b, nb = temporal_op.temporal_blend_reproject(
                    *planes, *whole[mesh[i]], temporal_p, row0=s)
                out = image = None
            else:
                b, nb, out, image = epilogue_op.still_epilogue(
                    *planes, *history[i], None if radius else g["albedo"],
                    row, keep_linear, row0=s)
            if reproject and not radius:
                image, out = epilogue_op.encode(b, e - s, w, g["albedo"], row,
                                                keep_linear)
            blended.append(b)
            next_blend.append(nb)
            outs.append(out)
            images.append(image)
        if radius:
            for i, ((s, e), dev) in enumerate(zip(bounds, mesh)):
                lo, hi = max(0, s - radius), min(h_img, e + radius)
                win = [gather_rows(p, bounds, lo, hi, dev, self.count)
                       for p in (blended, [g["normal"] for g in gbufs],
                                 [g["depth"] for g in gbufs],
                                 [g["albedo"] for g in gbufs],
                                 [g["node"] for g in gbufs])]
                den = denoise_op.denoise(*win, denoise_p, radius, row0=lo)
                image, out = epilogue_op.encode(den, hi - lo, w, None, row,
                                                keep_linear)
                images[i] = image[s - lo:e - lo]
                outs[i] = out[:, s - lo:e - lo]

        new_state = {
            "accum_color": tuple(blended),
            "accum_blend": tuple(next_blend),
            "old_depth": tuple(g["depth"] for g in gbufs),
            "old_cam": np.array(cam, np.float32),
            "history_valid": True,
        }
        home = mesh[0]

        def cat(parts, dim=-2):
            return torch.cat([p.to(home) for p in parts], dim=dim)

        outputs = {
            "image": cat(images, dim=0),
            "depth": cat([g["depth"] for g in gbufs]),
            "rays": sum(g["rays"].to(home) for g in gbufs),
        }
        if not lean:
            hwc = lambda a: torch.movedim(a, 0, -1)  # noqa: E731
            outputs.update({
                "linear": hwc(cat(outs)),
                "trace_color": hwc(cat([g["color"] for g in gbufs])),
                "normal": hwc(cat([g["normal"] for g in gbufs])),
                "albedo": hwc(cat([g["albedo"] for g in gbufs])),
                "node": cat([g["node"] for g in gbufs]),
            })
        return new_state, outputs


def sharded_render_frame(
    mesh: Mesh,
    *,
    height: int,
    width: int,
    radius: int = 0,
    layout: str = "contiguous",
):
    """``(fn, shard_state)``: ``fn(state, tables, noise, cam,
    render_params, temporal_params, denoise_params, frame_number,
    lean=False)`` renders one frame over the mesh's slabs and returns
    ``(state, outputs)`` as ``engine.pipeline.render_frame`` does (it
    decides from the state whether the frame reprojects, and ``outputs``
    has its keys, assembled on ``mesh[0]``: the rows concatenated, the
    ray counters summed), bit-equal to it; ``tables`` and ``noise`` are
    :func:`scene_device_args`'s, the state's planes per slab.
    ``shard_state`` places a one-device state onto the mesh
    (:func:`gather_state` does the reverse).  ``fn.count`` counts the row
    blocks it copies (:class:`CopyCount`).  ``layout``: ``"contiguous"`` or
    ``"cyclic"``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if radius < 0 or width < 1:
        raise ValueError(f"invalid radius {radius} or width {width}")
    fn = SlabFrame(tuple(mesh), height, width, radius, layout)

    def place(state):
        return shard_state(state, fn.mesh, height)

    return fn, place
