"""The frame function and the host-side frame loop.

Counterpart of :mod:`voxtracer.engine.pipeline` on one device.  Each
frame runs four stages, planar (3, H, W) throughout:

1. trace: :func:`voxtracer_torch.ops.trace.render_sample` — the CUDA
   kernel on the card, its plain torch version on the CPU;
2. temporal: with live history and a moved camera, the reprojecting
   blend :func:`voxtracer_torch.ops.temporal.temporal_blend_reproject`
   (CUDA kernel / plain version); otherwise the elementwise still blend;
3. denoise: :func:`voxtracer_torch.ops.denoise.denoise` — the
   cross-bilateral stencil for radius >= 1 (CUDA kernel / plain
   version), then the albedo modulate;
4. the u8 sRGB encode.

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops import denoise as denoise_op
from ..ops import temporal as temporal_op
from ..ops import tonemap
from ..ops import trace as trace_op
from ..ops.noise import blue_noise_buffer
from .camera import Camera
from .params import (
    DENOISE_RADIUS_DEFAULT,
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_denoise_params,
    pack_temporal_params,
    pack_trace_params,
)
from .scene import GridScene, SceneTables


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
        for k in ("accum_color", "accum_blend", "old_depth")
    }
    out["old_cam"] = np.array(state["old_cam"], dtype=np.float32).reshape(4, 3)
    out["history_valid"] = bool(np.asarray(state["history_valid"]))
    return out


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The state as numpy arrays, keyed and laid out as the reference
    package's ``Renderer.state``."""
    out = {
        k: state[k].detach().cpu().numpy()
        for k in ("accum_color", "accum_blend", "old_depth")
    }
    out["old_cam"] = np.array(state["old_cam"], np.float32)
    out["history_valid"] = np.bool_(state["history_valid"])
    return out


def camera_moved(state, cam: np.ndarray) -> bool:
    """True unless history is live and was rendered from ``cam``."""
    return not state["history_valid"] or not np.array_equal(
        cam, state["old_cam"]
    )


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
):
    """One frame: ``(state, outputs)``.  ``trace``, ``temporal`` (the
    reprojecting blend) and ``denoise`` are the device stages; only a
    comparison of the kernels with their plain versions replaces them."""
    gbuf = trace(
        tables,
        pack_trace_params(cam, render_params),
        noise,
        frame_number,
        height,
        width,
    )
    history = (state["accum_color"], state["accum_blend"], state["old_depth"])
    if state["history_valid"] and camera_moved(state, cam):
        blended, next_blend = temporal(
            gbuf["color"],
            gbuf["normal"],
            gbuf["depth"],
            *history,
            pack_temporal_params(cam, state["old_cam"], temporal_params, True),
        )
    else:
        blended, next_blend = temporal_op.temporal_blend_still_planar(
            gbuf["color"],
            gbuf["normal"],
            gbuf["depth"],
            *history,
            cam,
            state["old_cam"],
            temporal_params,
            state["history_valid"],
        )
    out = denoise(
        blended,
        gbuf["normal"],
        gbuf["depth"],
        gbuf["albedo"],
        gbuf["node"],
        pack_denoise_params(cam, denoise_params),
        radius,
    )
    new_state = {
        "accum_color": blended,
        "accum_blend": next_blend,
        "old_depth": gbuf["depth"],
        "old_cam": np.array(cam, np.float32),
        "history_valid": True,
    }
    outputs = {
        "image": tonemap.to_u8_planar_cropped(out, height, width),
        "depth": gbuf["depth"],
        "rays": gbuf["rays"],
    }
    if not lean:
        hwc = lambda a: torch.movedim(a, 0, -1)  # noqa: E731
        outputs.update(
            {
                "linear": hwc(out),
                "trace_color": hwc(gbuf["color"]),
                "normal": hwc(gbuf["normal"]),
                "albedo": hwc(gbuf["albedo"]),
                "node": gbuf["node"],
            }
        )
    return new_state, outputs


@dataclasses.dataclass
class Renderer:
    """Host-side frame loop: owns the scene tables, noise and state on
    ``device`` and advances frames (the reference's frame and
    still-sample counters, camera-motion detection, scene swap, resize).
    ``device="cuda"`` without a usable GPU raises.  ``trace``,
    ``temporal`` and ``denoise`` are the frame's device stages (see
    :func:`render_frame`)."""

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
    trace: Callable = trace_op.render_sample
    temporal: Callable = temporal_op.temporal_blend_reproject
    denoise: Callable = denoise_op.denoise

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

    def set_scene(self, scene: GridScene):
        """Swap scenes and restart accumulation."""
        self.scene = scene
        self.tables = SceneTables(scene, self.device)
        self.reset_accumulation()

    def reset_accumulation(self):
        self.state = init_state(self.height, self.width, self.device)
        self.still_sample = 0

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
        cam = camera.rows(self.width, self.height)
        moved = camera_moved(self.state, cam)
        self.state, outputs = render_frame(
            self.state,
            self.tables,
            self.noise,
            cam,
            self.render_params,
            self.temporal_params,
            self.denoise_params,
            self.frame_number + 1,
            self.height,
            self.width,
            radius=self.denoise_radius,
            lean=self.lean if lean is None else lean,
            trace=self.trace,
            temporal=self.temporal,
            denoise=self.denoise,
        )
        self.frame_number += 1
        self.still_sample = 1 if moved else self.still_sample + 1
        return outputs
