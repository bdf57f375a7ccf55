"""The frame function and the host-side frame loop.

Counterpart of :mod:`voxtracer.engine.pipeline` on one device.  Each
frame runs these stages, planar (3, H, W) throughout:

1. trace: :func:`voxtracer_torch.ops.trace.render_sample` — the CUDA
   kernel on the card, its plain torch version on the CPU;
2. temporal: with live history and a moved camera, the reprojecting
   blend :func:`voxtracer_torch.ops.temporal.temporal_blend_reproject`
   (CUDA kernel / plain version); otherwise the still blend, the first
   part of :func:`voxtracer_torch.ops.epilogue.still_epilogue`;
3. denoise: for radius >= 1 the cross-bilateral stencil and the albedo
   modulate, :func:`voxtracer_torch.ops.denoise.denoise` (CUDA kernel /
   plain version); radius 0 is the modulate alone, inside the epilogue;
4. the u8 sRGB encode: :func:`voxtracer_torch.ops.epilogue.encode`, or,
   on a still frame at radius 0, the rest of the still epilogue, which
   blends, modulates and encodes in one pass (as XLA fuses the tail of
   the reference's frame).

On the card a frame is 2 launches (still, r = 0: trace + still
epilogue), 3 (moving, r = 0: + temporal + encode) or 4 (r >= 1: trace,
temporal kernel or the still epilogue's blend alone, denoise, encode).
``Renderer.render`` there enqueues them with one native call from a
frame plan checked once (:mod:`.direct`), the same kernels on the same
inputs; on the CPU it runs the stages one by one (:func:`render_frame`).
Both paths build a frame's state and outputs with :func:`frame_outputs`.

The first frame after construction, ``reset_accumulation`` or a resize
has no live history.  The reference sends it through the moving
camera's temporal kernel with history invalid, whose result is the
fresh sample everywhere — exactly what the still blend computes with
history invalid, so the port uses the still blend.

State: ``accum_color`` (3, H, W), ``accum_blend`` and ``old_depth``
(H, W) live on the device; ``old_cam`` ((4, 3) float32 numpy, the
camera the history was rendered from, which the reprojection reads) and
``history_valid`` (bool) stay on the host, where the Renderer reads them
without waiting for the device.

Every frame reads its parameters from one packed row
(:func:`voxtracer_torch.engine.params.pack_frame_rows`).  ``render()``
packs the row of its one frame and hands the stages its slices on the
host.  ``render_sequence`` / ``render_burst`` (the offline export path,
the reference's ``lax.scan`` over ``packed_seq``) pack a whole camera
path; on the card the rows go to the device once and every frame is one
replay of a captured CUDA graph whose stages read the row at a device
cursor (:class:`SequenceRunner`), on the CPU a loop over the same
stages reads row i.  All three launch the kernels of
:func:`frame_stages` on the same values, so a sequence is bit-equal to
as many ``render()`` calls.

Under a profiler the frame driver opens the spans ``vt.render`` (its
frame number), ``vt.render.pack`` (the row) and one
``vt.stage.<stage>`` a stage call, or on the direct path
``vt.render.launch`` (the arena and the native call) in their place;
the sequence driver ``vt.sequence`` (first frame, count) and
``vt.sequence.pack``, ``.rows``, ``.capture`` (where a graph is
captured), ``.state_in``, ``.replay`` and ``.state_out``
(:func:`voxtracer_torch.utils.timing.span`).  Graph captures and
replays, the rows' upload and the direct path's frames add to the
counts that :func:`counters` snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops import denoise as denoise_op
from ..ops import epilogue as epilogue_op
from ..ops import reproject as reproject_op
from ..ops import temporal as temporal_op
from ..ops import trace as trace_op
from ..ops.noise import blue_noise_buffer
from ..utils.timing import COUNTS, span
from . import direct
from .camera import Camera
from .params import (
    DENOISE_PARAMS_LEN,
    DENOISE_RADIUS_DEFAULT,
    ROW_DENOISE,
    ROW_FRAME,
    ROW_LEN,
    ROW_TEMPORAL,
    ROW_TRACE,
    TEMPORAL_PARAMS_LEN,
    TRACE_PARAMS_LEN,
    DenoiseParams,
    DeviceRow,
    RenderParams,
    TemporalParams,
    pack_frame_rows,
)
from .scene import GridScene, SceneTables


# the state's tensors on the device
STATE_PLANES = ("accum_color", "accum_blend", "old_depth")


def init_state(height: int, width: int, device) -> Dict:
    """Fresh accumulation state (history invalid)."""
    return {
        "accum_color": torch.zeros(
            (3, height, width), dtype=torch.float32, device=device
        ),
        "accum_blend": torch.ones(
            (height, width), dtype=torch.float32, device=device
        ),
        "old_depth": torch.full(
            (height, width), -1.0, dtype=torch.float32, device=device
        ),
        "old_cam": np.zeros((4, 3), np.float32),
        "history_valid": False,
    }


def state_from_numpy(state, device) -> Dict:
    """A state from numpy arrays with the reference package's keys and
    layouts (e.g. a JAX ``Renderer.state`` passed through ``np.asarray``)."""
    out = {
        k: torch.from_numpy(
            np.array(state[k], dtype=np.float32)
        ).to(torch.device(device))
        for k in STATE_PLANES
    }
    out["old_cam"] = np.array(state["old_cam"], dtype=np.float32).reshape(4, 3)
    out["history_valid"] = bool(np.asarray(state["history_valid"]))
    return out


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The state as numpy arrays, keyed and laid out as the reference
    package's ``Renderer.state``."""
    out = {k: state[k].detach().cpu().numpy() for k in STATE_PLANES}
    out["old_cam"] = np.array(state["old_cam"], np.float32)
    out["history_valid"] = np.bool_(state["history_valid"])
    return out


def camera_moved(state, cam: np.ndarray) -> bool:
    """True unless history is live and was rendered from ``cam``."""
    return not state["history_valid"] or not np.array_equal(
        cam, state["old_cam"]
    )


def frame_stages(
    history,  # (accum_color, accum_blend, old_depth)
    tables: SceneTables,
    noise: torch.Tensor,  # (S, 128, 128) f32 on the tables' device
    row,  # the frame's row on the host, or its DeviceRow
    reproject: bool,  # a moved camera meets live history
    height: int,
    width: int,
    radius: int,
    trace: Callable,
    temporal: Callable,
    denoise: Callable,
    still_epilogue: Callable,
    encode: Callable,
    keep_linear: bool = False,
    dest=None,  # (frames, slot): write the image at frames[slot]
    in_place: bool = False,  # a still frame blends into ``history``
):
    """Trace, temporal blend, denoise and u8 encode of the frame whose
    parameters ``row`` holds.  A numpy row gives the stages its slices
    by value; a :class:`DeviceRow` makes every stage read the row on the
    device.  Returns ``(gbuf, blended, next_blend, out, image)``: ``out``
    is the linear frame the image encodes (None at radius 0 unless
    ``keep_linear``), ``image`` None where ``dest`` took it.  With
    ``in_place`` a still frame's epilogue overwrites ``history`` with
    its blend, next blend and depth (``blended`` and ``next_blend`` are
    then its first two planes); a reprojecting frame leaves it as it
    is."""
    if isinstance(row, DeviceRow):
        trace_p = temporal_p = denoise_p = row
        frame = None  # in the device row
    else:
        trace_p = row[ROW_TRACE:ROW_TRACE + TRACE_PARAMS_LEN]
        temporal_p = row[ROW_TEMPORAL:ROW_TEMPORAL + TEMPORAL_PARAMS_LEN]
        denoise_p = row[ROW_DENOISE:ROW_DENOISE + DENOISE_PARAMS_LEN]
        frame = int(row[ROW_FRAME:ROW_FRAME + 1].view(np.int32)[0])
    with span("vt.stage.trace"):
        gbuf = trace(tables, trace_p, noise, frame, height, width)
    planes = (gbuf["color"], gbuf["normal"], gbuf["depth"], *history)
    # radius 0: the modulate rides the encode (or the still epilogue)
    albedo = None if radius else gbuf["albedo"]
    if not reproject:
        with span("vt.stage.still_epilogue"):
            blended, next_blend, out, image = still_epilogue(
                *planes, albedo, row, keep_linear, dest, in_place=in_place)
        if not radius:
            return gbuf, blended, next_blend, out, image
    else:
        with span("vt.stage.temporal"):
            blended, next_blend = temporal(*planes, temporal_p)
    out = blended
    if radius:
        with span("vt.stage.denoise"):
            out = denoise(blended, gbuf["normal"], gbuf["depth"],
                          gbuf["albedo"], gbuf["node"], denoise_p, radius)
    with span("vt.stage.encode"):
        image, out = encode(out, height, width, albedo, row, keep_linear,
                            dest)
    return gbuf, blended, next_blend, out, image


def render_frame(
    state: Dict,
    tables: SceneTables,
    noise: torch.Tensor,  # (S, 128, 128) f32 on the tables' device
    cam: np.ndarray,  # (4, 3) f32: origin, right, up, forward (scaled)
    render_params: RenderParams,
    temporal_params: TemporalParams,
    denoise_params: DenoiseParams,
    frame_number: int,
    height: int,
    width: int,
    radius: int = 0,
    lean: bool = False,
    trace: Callable = trace_op.render_sample,
    temporal: Callable = temporal_op.temporal_blend_reproject,
    denoise: Callable = denoise_op.denoise,
    still_epilogue: Callable = epilogue_op.still_epilogue,
    encode: Callable = epilogue_op.encode,
):
    """One frame: ``(state, outputs)``.  ``trace``, ``temporal`` (the
    reprojecting blend), ``denoise``, ``still_epilogue`` and ``encode``
    are the device stages; only a comparison of the kernels with their
    plain versions (or with other compositions) passes others."""
    with span("vt.render.pack"):
        row = pack_frame_rows(
            [cam], state["old_cam"], state["history_valid"], frame_number,
            render_params, temporal_params, denoise_params,
        )[0]
    gbuf, blended, next_blend, out, image = frame_stages(
        tuple(state[k] for k in STATE_PLANES), tables, noise, row,
        state["history_valid"] and camera_moved(state, cam),
        height, width, radius, trace, temporal, denoise, still_epilogue,
        encode, keep_linear=not lean,
    )
    return frame_outputs(cam, gbuf, blended, next_blend, out, image, lean)


def frame_outputs(cam: np.ndarray, gbuf, blended, next_blend, linear, image,
                  lean: bool):
    """A frame's ``(state, outputs)`` from its planar tensors, on either
    path (:func:`render_frame`, :class:`.direct.FramePlan`): the new
    state, and the outputs ``image``, ``depth`` and ``rays``; unless
    ``lean`` also the ``linear`` frame and the G-buffer's ``color``,
    ``normal`` and ``albedo`` as (H, W, 3) views, and its ``node`` ids,
    which ``gbuf`` then holds."""
    state = {
        "accum_color": blended,
        "accum_blend": next_blend,
        "old_depth": gbuf["depth"],
        "old_cam": np.array(cam, np.float32),
        "history_valid": True,
    }
    outputs = {
        "image": image,
        "depth": gbuf["depth"],
        "rays": gbuf["rays"],
    }
    if not lean:
        hwc = lambda a: torch.movedim(a, 0, -1)  # noqa: E731
        outputs.update(
            {
                "linear": hwc(linear),
                "trace_color": hwc(gbuf["color"]),
                "normal": hwc(gbuf["normal"]),
                "albedo": hwc(gbuf["albedo"]),
                "node": gbuf["node"],
            }
        )
    return state, outputs


# the counts that grow with the denoise's launches (``ops/denoise.py``):
# a replayed graph adds what they counted while it was captured, as
# launches
DENOISE_COUNTS = ("denoise.resident_warps", "denoise.reciprocal_launches")


def counted_kernels() -> Dict[str, Callable]:
    """The frame kernels' wrappers by stage: a replayed graph adds what
    they counted while it was captured.  Looked up at each call: a
    hot-reloaded module (``engine/reload.py``) has new ones."""
    return {
        "trace": trace_op.render_sample_cuda,
        "temporal": temporal_op.temporal_blend_reproject_cuda,
        "denoise": denoise_op.denoise_cuda,
        "resample": reproject_op.resample_cuda,
        "still_epilogue": epilogue_op.still_epilogue_cuda,
        "encode": epilogue_op.encode_cuda,
    }


def counters() -> Dict[str, int]:
    """The counts so far, each monotone: ``launches.<stage>`` of each
    frame kernel (its wrapper's ``launches``; a hot-reloaded wrapper
    takes its predecessor's over), then ``utils.timing.COUNTS``."""
    out = {f"launches.{stage}": kernel.launches
           for stage, kernel in counted_kernels().items()}
    out.update(COUNTS)
    return out


class SequenceRunner:
    """A camera path's frames on the card, one CUDA-graph replay each.

    A captured graph freezes every address and every by-value kernel
    argument, so what changes from frame to frame lives in buffers this
    object owns: the path's rows and a device cursor into them, the
    carried state (a still frame's epilogue blends straight into it; a
    reprojecting frame's blend is copied into it at the frame's end: the
    temporal kernel gathers neighbours of the history and cannot blend
    in place), and the u8 frames, which the epilogue
    kernels write at a device slot that advances by a device step (1 for
    a sequence, 0 for a burst, which so holds one image whatever its
    length).  The last nodes of the graph advance cursor and slot, so
    one graph per kind of frame (still blend, reprojecting blend) serves
    any segment length.

    The graphs are captured after one eager frame has built the kernels
    and set their attributes.  They share one memory pool: each frame's
    results are in the static buffers (written there, or copied there)
    before the next replay.
    A failed capture or replay raises; nothing falls back to the loop.
    Captures and replays go to the current stream, and the row-reading
    kernels stage their rows in one constant-memory slot per process: one
    stream renders at a time.
    """

    def __init__(self, key, tables, noise, height, width, radius, stages):
        self.key = key
        self.tables, self.noise = tables, noise
        self.height, self.width, self.radius = height, width, radius
        self.stages = stages  # trace, temporal, denoise, still, encode
        dev = tables.device
        self.state = {k: v for k, v in init_state(height, width, dev).items()
                      if k in STATE_PLANES}
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rows = torch.zeros((0, ROW_LEN), dtype=torch.float32, device=dev)
        self.frames = torch.zeros((0, height, width, 3), dtype=torch.uint8,
                                  device=dev)
        self.host_row = None
        # kind of frame -> (graph, launches a replay, resident warps a replay)
        self.graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph, List[int],
                                      int]] = {}
        self.pool = None

    def load_rows(self, rows: np.ndarray, n_frames: int):
        """Room for these rows and ``n_frames`` images, and the rows on
        the device.  Buffers that grow move, which drops the graphs."""
        dev = self.rows.device
        if len(rows) > len(self.rows) or n_frames > len(self.frames):
            self.graphs, self.pool = {}, None
            if len(rows) > len(self.rows):
                self.rows = torch.zeros((len(rows), ROW_LEN),
                                        dtype=torch.float32, device=dev)
            if n_frames > len(self.frames):
                self.frames = torch.zeros(
                    (n_frames, self.height, self.width, 3),
                    dtype=torch.uint8, device=dev)
        # from pageable memory: the host waits for the copy
        self.rows[:len(rows)].copy_(torch.from_numpy(rows))
        COUNTS["host.waits"] += 1
        self.host_row = rows[0].copy()

    def load_state(self, state: Dict, stack: bool):
        """The carried state in, cursor and slot at the start."""
        for k in STATE_PLANES:
            self.state[k].copy_(state[k])
        self.cursor.zero_()
        self.slot.zero_()
        self.step.fill_(int(stack))

    def frame(self, reproject: bool):
        """The frame at the cursor, then the cursor and slot advanced;
        every operation on the device, none waiting for the host."""
        row = DeviceRow(self.rows.index_select(0, self.cursor)[0],
                        self.host_row)
        gbuf, blended, next_blend, _, _ = frame_stages(
            tuple(self.state[k] for k in STATE_PLANES), self.tables,
            self.noise, row, reproject, self.height, self.width,
            self.radius, *self.stages, dest=(self.frames, self.slot),
            in_place=not reproject,
        )
        if reproject:
            self.state["accum_color"].copy_(blended)
            self.state["accum_blend"].copy_(next_blend)
            self.state["old_depth"].copy_(gbuf["depth"])
        self.cursor.add_(1)
        self.slot.add_(self.step)

    def capture(self, reproject: bool):
        """The graph of this kind of frame, unless it is there: one
        eager frame first (it builds the kernels and sets their
        attributes; it also overwrites state and cursor, so captures
        come before :meth:`load_state`), then the capture, which
        launches nothing: the launches the wrappers counted during it,
        and what its denoise launch added to ``DENOISE_COUNTS``, become
        the graph's counts per replay."""
        if reproject in self.graphs:
            return
        with span("vt.sequence.capture"):
            self.cursor.zero_()
            self.slot.zero_()
            self.frame(reproject)
            self.cursor.zero_()
            self.slot.zero_()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            kernels = counted_kernels().values()
            before = [k.launches for k in kernels]
            counts = [COUNTS[name] for name in DENOISE_COUNTS]
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    self.frame(reproject)
                per_replay = [k.launches - n for k, n in zip(kernels, before)]
                counts_per_replay = [COUNTS[name] - n for name, n in
                                     zip(DENOISE_COUNTS, counts)]
            finally:  # a capture that raised launched nothing either
                for kernel, n in zip(kernels, before):
                    kernel.launches = n
                for name, n in zip(DENOISE_COUNTS, counts):
                    COUNTS[name] = n
            self.graphs[reproject] = (graph, per_replay, counts_per_replay)
            COUNTS["graph.captures"] += 1

    def run(self, segments, graph: bool):
        """Every frame of the loaded path, segment by segment."""
        for start, end, reproject in segments:
            if not graph:
                for _ in range(start, end):
                    self.frame(reproject)
                continue
            captured, per_replay, counts = self.graphs[reproject]
            for _ in range(start, end):
                captured.replay()
            COUNTS["graph.replays"] += end - start
            for kernel, n in zip(counted_kernels().values(), per_replay):
                kernel.launches += n * (end - start)
            for name, n in zip(DENOISE_COUNTS, counts):
                COUNTS[name] += n * (end - start)


@dataclasses.dataclass
class Renderer:
    """Host-side frame loop: owns the scene tables, noise and state on
    ``device`` and advances frames (the reference's frame and
    still-sample counters, camera-motion detection, scene swap, resize).
    ``device="cuda"`` without a usable GPU raises.  It runs the package's
    own stages (:meth:`_stages`).  ``render`` is the realtime frame;
    ``render_sequence`` and ``render_burst`` render a camera path known
    up front with one host call, and leave state and counters as that
    many ``render`` calls would."""

    scene: GridScene
    height: int
    width: int
    device: str = "cuda"
    render_params: RenderParams = RenderParams()
    temporal_params: TemporalParams = TemporalParams()
    denoise_params: DenoiseParams = DenoiseParams()
    denoise_radius: int = DENOISE_RADIUS_DEFAULT
    noise_buffer: Optional[np.ndarray] = None
    lean: bool = False

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False"
            )
        if self.noise_buffer is None:
            self.noise_buffer = blue_noise_buffer()
        self.noise = torch.from_numpy(
            np.ascontiguousarray(self.noise_buffer, np.float32)
        ).to(self.device)
        self.tables = SceneTables(self.scene, self.device)
        self.state = init_state(self.height, self.width, self.device)
        self.frame_number = 0
        self.still_sample = 0
        self._runner: Optional[SequenceRunner] = None
        self._plan: Optional[direct.FramePlan] = None

    def set_scene(self, scene: GridScene):
        """Swap scenes and restart accumulation."""
        self.scene = scene
        self.tables = SceneTables(scene, self.device)
        self.reset_accumulation()

    def reset_accumulation(self):
        """Fresh state; the sequence path's buffers and graphs go too."""
        self.state = init_state(self.height, self.width, self.device)
        self.still_sample = 0
        self._runner = None

    def resize(self, height: int, width: int):
        """Restart accumulation at a new image size (history is
        size-bound); the scene tables stay."""
        if (height, width) == (self.height, self.width):
            return
        if height <= 0 or width <= 0:
            raise ValueError(f"invalid size {width}x{height}")
        self.height = int(height)
        self.width = int(width)
        self.reset_accumulation()

    def render(
        self, camera: Camera, lean: Optional[bool] = None
    ) -> Dict[str, torch.Tensor]:
        """The next frame at ``camera``: its outputs (``image``, ``depth``,
        ``rays``, and unless ``lean`` the planes of :func:`render_frame`)
        and the new state, in memory that no later frame writes.  On the
        card one native call enqueues it (:mod:`.direct`); on the CPU the
        stages run one by one (:func:`render_frame`)."""
        frame = self.frame_number + 1
        lean = self.lean if lean is None else lean
        with span("vt.render", {"frame": frame}):
            cam = camera.rows(self.width, self.height)
            moved = camera_moved(self.state, cam)
            if direct.engages(self.device):
                self.state, outputs = self._frame_plan().render(
                    self.state, cam, self.state["history_valid"] and moved,
                    frame, self.render_params, self.temporal_params,
                    self.denoise_params, lean)
            else:
                self.state, outputs = render_frame(
                    self.state, self.tables, self.noise, cam,
                    self.render_params, self.temporal_params,
                    self.denoise_params, frame, self.height, self.width,
                    self.denoise_radius, lean, *self._stages())
        self.frame_number = frame
        self.still_sample = 1 if moved else self.still_sample + 1
        return outputs

    def _pack_sequence(self, cameras: Sequence[Camera]):
        """A camera path's rows, its per-frame reproject flags (True
        where a moved camera meets live history), and the
        ``still_sample`` and last camera rows that it ends on."""
        if not len(cameras):
            raise ValueError("render_sequence needs at least one camera")
        # one basis per camera object: a burst repeats one
        basis = {id(c): c for c in cameras}
        basis = {k: c.rows(self.width, self.height) for k, c in basis.items()}
        cams = np.stack([basis[id(c)] for c in cameras])
        valid = self.state["history_valid"]
        rows = pack_frame_rows(
            cams, self.state["old_cam"], valid, self.frame_number + 1,
            self.render_params, self.temporal_params, self.denoise_params,
        )
        # frame i moved unless history is live and was rendered from its
        # camera: frame i - 1's, or for the first frame the state's
        moved = np.ones(len(cams), bool)
        moved[1:] = (cams[1:] != cams[:-1]).any(axis=(1, 2))
        moved[0] = camera_moved(self.state, cams[0])
        flags = moved.copy()
        flags[0] = moved[0] and valid
        still = self.still_sample
        for m in moved.tolist():
            still = 1 if m else still + 1
        return rows, flags.tolist(), still, cams[-1]

    @staticmethod
    def _segments(flags):
        """Run-length encode the per-frame reproject flags into
        ``(start, end, reproject)`` segments: each runs one kind of
        frame, the still blend or the reprojecting blend."""
        segs = []
        start = 0
        for i in range(1, len(flags)):
            if flags[i] != flags[start]:
                segs.append((start, i, flags[start]))
                start = i
        segs.append((start, len(flags), flags[start]))
        return segs

    def _finish_sequence(self, n: int, still: int, last_cam: np.ndarray):
        self.frame_number += n
        self.still_sample = still
        self.state["old_cam"] = np.array(last_cam, np.float32)
        self.state["history_valid"] = True

    @staticmethod
    def _stages() -> Tuple[Callable, ...]:
        """The package's stages, in :func:`frame_stages` order, read from
        their modules at each call: ``importlib.reload`` refills the same
        module objects, so a hot-reloaded module's (``engine/reload.py``)
        are picked up."""
        return (trace_op.render_sample, temporal_op.temporal_blend_reproject,
                denoise_op.denoise, epilogue_op.still_epilogue,
                epilogue_op.encode)

    def _config_key(self) -> tuple:
        """What a frame plan and a sequence runner freeze: size, radius,
        tables, noise and the denoise kernel's by-value parameters."""
        p = self.denoise_params
        return (
            self.height, self.width, self.denoise_radius, id(self.tables),
            id(self.noise),
            # by value in the denoise kernel's launch
            (p.sigma_distance, p.sigma_range, p.albedo_factor)
            if self.denoise_radius else None,
        )

    def _frame_plan(self) -> direct.FramePlan:
        """The frame plan of this configuration and kernel library; a new
        one once either has changed."""
        lib = _build.load()
        key = (*self._config_key(), lib)
        if self._plan is None or self._plan.key != key:
            self._plan = direct.FramePlan(
                key, lib, self.tables, self.noise, self.height, self.width,
                self.denoise_radius, self.denoise_params.sigma_distance,
                self.denoise_params.sigma_range, counted_kernels())
        return self._plan

    def _sequence_runner(self) -> SequenceRunner:
        """The runner of this configuration; a new one, without graphs,
        once anything that a capture freezes has changed."""
        key = self._config_key()
        if self._runner is None or self._runner.key != key:
            self._runner = SequenceRunner(
                key, self.tables, self.noise, self.height, self.width,
                self.denoise_radius, self._stages(),
            )
        return self._runner

    def _run_sequence(self, cameras, stack: bool, graph: bool):
        """The frames of a camera path: all of them stacked, or the last
        one.  State and counters advance as in ``len(cameras)`` calls of
        :meth:`render`."""
        with span("vt.sequence", {"frame": self.frame_number + 1,
                                  "count": len(cameras)}):
            cuda = self.device.type == "cuda"
            with span("vt.sequence.pack"):
                rows, flags, still, last = self._pack_sequence(cameras)
                segments = self._segments(flags) if cuda else None
            n = len(rows)
            if cuda:
                runner = self._sequence_runner()
                with span("vt.sequence.rows"):
                    runner.load_rows(rows, n if stack else 1)
                if graph:
                    for reproject in sorted({seg[2] for seg in segments}):
                        runner.capture(reproject)
                with span("vt.sequence.state_in"):
                    runner.load_state(self.state, stack)
                with span("vt.sequence.replay"):
                    runner.run(segments, graph)
                # out of the buffers the next sequence overwrites
                with span("vt.sequence.state_out"):
                    self.state.update(
                        {k: runner.state[k].clone() for k in STATE_PLANES})
                    frames = (runner.frames[:n] if stack
                              else runner.frames[0]).clone()
            else:
                history = tuple(self.state[k] for k in STATE_PLANES)
                images = []
                for row, reproject in zip(rows, flags):
                    gbuf, blended, next_blend, _, image = frame_stages(
                        history, self.tables, self.noise, row, reproject,
                        self.height, self.width, self.denoise_radius,
                        *self._stages(),
                    )
                    history = (blended, next_blend, gbuf["depth"])
                    if stack:
                        images.append(image)
                    else:
                        images = [image]
                self.state.update(zip(STATE_PLANES, history))
                frames = torch.stack(images) if stack else images[0]
            self._finish_sequence(n, still, last)
            return frames

    def render_sequence(
        self, cameras: Sequence[Camera], graph: bool = True
    ) -> torch.Tensor:
        """Render ``len(cameras)`` frames with one host call; returns the
        (N, H, W, 3) u8 frames on the device.

        On the card the path's rows go to the device once and each frame
        is one replay of a captured CUDA graph (one graph per kind of
        frame, whatever the path's length; a path that alternates
        between still and moving frames only costs more replay calls).
        A failed capture or replay raises.  ``graph=False`` runs the
        same frames eagerly, for comparisons.  On the CPU there is no
        graph: a loop over the same stages.  The frames stay on the
        device: at 3840x2160 a frame is 24 MB, so split long exports
        into several calls."""
        return self._run_sequence(cameras, True, graph)

    def render_burst(
        self, camera: Camera, n: int, graph: bool = True
    ) -> torch.Tensor:
        """``n`` accumulation passes at one camera with one host call;
        returns the last (H, W, 3) u8 frame.  The frames before it are
        never kept: a burst holds one image whatever its length."""
        return self._run_sequence([camera] * n, False, graph)
