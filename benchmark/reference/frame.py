"""The reference frame: what one ``Renderer.render()`` computes, from
the carried state and the camera, in plain torch.

A frame traces one sample a pixel; where a moved camera meets live
history it blends by reprojection, otherwise by the still blend (history
invalid: the fresh sample); radius >= 1 denoises; the u8 image encodes
the linear colour (at radius 0 modulated by the albedo).  The next state
is the blend, the next blend and this frame's depth.

``lowp`` is the correctness control: the same frame with every plane
that passes from one stage to the next, and the carried state, held in
bfloat16 (the arithmetic of each stage stays float32), the step a
change that halves the planes' bytes would take.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import stages
from .camera import Camera
from .params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_denoise_params,
    pack_temporal_params,
    pack_trace_params,
)
from .trace import trace_rays

STATE_PLANES = ("accum_color", "accum_blend", "old_depth")
RP, TP, DP = RenderParams(), TemporalParams(), DenoiseParams()


def _q(t: torch.Tensor, lowp: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if lowp else t


def camera_rows(position, direction, width: int, height: int) -> np.ndarray:
    """(4, 3) float32 rows of the camera at ``position`` looking along
    ``direction``."""
    return Camera(position=np.asarray(position, np.float64),
                  direction=np.asarray(direction, np.float64)).rows(
                      width, height)


def _call_key(p: RenderParams) -> RenderParams:
    """What frames of one trace call share: their parameters but the
    sun's yaw and pitch, which the call takes ray by ray."""
    return dataclasses.replace(p, sun_yaw=0.0, sun_pitch=0.0)


def trace_batch(tables, noise, cams: Sequence[np.ndarray],
                frames: Sequence[int], height: int, width: int,
                chunk: int = 1 << 26,
                params: Optional[Sequence[RenderParams]] = None):
    """The trace of whole frames, each with its camera rows, frame
    number and ``RenderParams`` (``params``; ``RP`` for every frame by
    default), each frame's trace row packed from its own, as many
    frames a call as ``chunk`` rays hold (at least one) and as follow
    each other with parameters that differ in the sun alone: a list of
    planar outputs, each with its own ``rays`` and ``steps`` (6,).  A
    call lasts as many loop iterations as its slowest ray takes steps (up
    to 2048 at a grazing ray), whatever the number of rays, so the frames
    go in as few calls as memory allows, each ray with its frame's camera
    and, where the call's frames differ in it, its frame's sun."""
    dev = tables.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    n = height * width
    ys, xs = ys.reshape(n), xs.reshape(n)
    k = len(cams)
    params = [RP] * k if params is None else list(params)
    rows = [pack_trace_params(c, p) for c, p in zip(cams, params)]
    per = max(1, chunk // n)
    outs = []
    s = 0
    while s < k:
        e = s + 1
        while e < min(k, s + per) and \
                _call_key(params[e]) == _call_key(params[s]):
            e += 1
        idx = range(s, e)
        m = len(idx)
        cam_t = torch.from_numpy(np.stack(
            [np.asarray(cams[i], np.float32).reshape(12) for i in idx])).to(dev)
        sun = np.stack([rows[i][24:30] for i in idx])
        sun_t = None if (sun == sun[0]).all() else torch.from_numpy(
            sun).to(dev).repeat_interleave(n, dim=0)
        frame_t = torch.tensor([int(frames[i]) for i in idx], device=dev)
        g = trace_rays(tables, rows[s], noise, frame_t.repeat_interleave(n),
                       ys.repeat(m), xs.repeat(m),
                       cams=cam_t.repeat_interleave(n, dim=0), suns=sun_t)
        for j in range(m):
            sl = slice(j * n, (j + 1) * n)
            o = {key: g[key][..., sl] for key in
                 ("color", "normal", "albedo", "depth", "node")}
            for key in ("color", "normal", "albedo"):
                o[key] = o[key].reshape(3, height, width)
            for key in ("depth", "node"):
                o[key] = o[key].reshape(height, width)
            o["rays"] = g["ray_rays"][:, sl].sum(1)
            o["steps"] = g["ray_steps"][:, sl].sum(1, dtype=torch.int64)
            outs.append(o)
        del g
        s = e
    return outs


def render_frames(tables, noise, state: Dict, cams: Sequence[np.ndarray],
                  frames: Sequence[int], radius: int, lowp: bool = False,
                  traces=None,
                  params: Optional[Sequence[RenderParams]] = None):
    """Consecutive frames from ``state`` (the three planes, ``old_cam``,
    ``history_valid``), frame i at camera rows ``cams[i]`` with frame
    number ``frames[i]`` and parameters ``params[i]`` (``RP`` for every
    frame by default); ``traces``: their :func:`trace_batch` outputs,
    where already traced.  Returns ``(images, states)``: each frame's
    (H, W, 3) u8 image and the state after it."""
    height, width = state["old_depth"].shape
    if traces is None:
        traces = trace_batch(tables, noise, cams, frames, height, width,
                             params=params)
    images, states = [], []
    for cam, g in zip(cams, traces):
        cam = np.asarray(cam, np.float32)
        valid = bool(state["history_valid"])
        moved = not valid or not np.array_equal(cam, state["old_cam"])
        old_cam = state["old_cam"] if valid else cam
        color, normal, depth, albedo = (
            _q(g[k], lowp) for k in ("color", "normal", "depth", "albedo"))
        hist = tuple(state[k] for k in STATE_PLANES)
        if valid and moved:
            blended, next_blend = stages.blend_reproject(
                color, normal, depth, *hist,
                pack_temporal_params(cam, old_cam, TP, valid))
        else:
            dev = depth.device
            px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
            py = torch.arange(height, device=dev,
                              dtype=torch.float32)[:, None]
            blended, next_blend = stages.blend_still(
                color, normal, depth, *hist, px, py, cam, old_cam, TP, valid)
        blended, next_blend = _q(blended, lowp), _q(next_blend, lowp)
        if radius:
            out = stages.denoise(blended, normal, depth, albedo, g["node"],
                                 pack_denoise_params(cam, DP), radius)
        else:
            out = stages.modulate(blended, albedo, DP.albedo_factor)
        images.append(stages.to_u8(_q(out, lowp)))
        state = {"accum_color": blended, "accum_blend": next_blend,
                 "old_depth": depth, "old_cam": cam, "history_valid": True}
        states.append(state)
    return images, states


def burst_pixels(tables, noise, state: Dict, cam: np.ndarray,
                 frames: Sequence[int], ys: torch.Tensor, xs: torch.Tensor,
                 lowp: bool = False, chunk: int = 1 << 20):
    """``len(frames)`` still frames at camera ``cam`` and radius 0 at the
    listed pixels only (each pixel's frames depend on that pixel alone):
    ``state`` holds the planes at those pixels ((3, n) and (n,)).  The
    pixels' samples of all frames are traced together, ``chunk`` rays a
    call.  Returns ``(image (n, 3) u8 of the last frame, next state)``."""
    n, dev = xs.shape[0], xs.device
    frames_t = torch.as_tensor(list(frames), device=dev)
    k = frames_t.shape[0]
    all_f = frames_t.repeat_interleave(n)
    all_y, all_x = ys.repeat(k), xs.repeat(k)
    params = pack_trace_params(cam, RP)
    parts = []
    for s in range(0, k * n, chunk):
        parts.append(trace_rays(tables, params, noise, all_f[s:s + chunk],
                                all_y[s:s + chunk], all_x[s:s + chunk]))
    cat = {key: torch.cat([p[key] for p in parts], dim=-1)
           for key in ("color", "normal", "depth", "albedo")}
    valid = bool(state["history_valid"])
    old_cam = state["old_cam"] if valid else cam
    color, blend, depth = (state[key] for key in STATE_PLANES)
    px, py = xs.to(torch.float32), ys.to(torch.float32)
    for i in range(k):
        sl = slice(i * n, (i + 1) * n)
        c, nrm, d, alb = (_q(cat[key][..., sl], lowp) for key in
                          ("color", "normal", "depth", "albedo"))
        moved = not valid or not np.array_equal(cam, old_cam)
        if valid and moved:
            raise ValueError("burst_pixels renders still frames only")
        color, blend = stages.blend_still(c, nrm, d, color, blend, depth,
                                          px, py, cam, old_cam, TP, valid)
        color, blend, depth = _q(color, lowp), _q(blend, lowp), d
        valid, old_cam = True, cam
    image = stages.to_u8(_q(stages.modulate(color, alb, DP.albedo_factor),
                            lowp))
    nxt = {"accum_color": color, "accum_blend": blend, "old_depth": depth,
           "old_cam": np.array(cam, np.float32), "history_valid": True}
    return image, nxt
