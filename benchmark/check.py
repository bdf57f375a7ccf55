"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), run from the
same carried state at the same cameras and frame numbers.

Two numbers a cell, each the worst over the run's compared frames:

* ``image_off``: the share of a frame's u8 values (every pixel and
  channel compared) that differ from the reference's by more than 1;
* ``state_off``: the share of the carried state's values (the blend,
  the next blend and the depth) that differ from the reference's by
  more than ``STATE_REL`` of the reference's magnitude (at least
  ``STATE_FLOOR``).

The reference follows the port's operation order, so where the kernels
round as their plain versions do both read 0; a transcendental that
rounds otherwise on the card moves one path's colour, which the share
counts once.  The control (the reference with its planes in bfloat16)
moves nearly every value.  The reference takes from the program only the
state that a unit kept in the window started from; the cameras (the
previous frame's included), suns, frame numbers and the validity of the
history are the harness's own.  One unit a run, the warm-up's frames,
starts from the reference's own fresh state, so the state the program
carries is also held against a chain the reference computed alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .reference import frame as ref_frame

STATE_REL = 1e-4
STATE_FLOOR = 1e-3
PLANES = ref_frame.STATE_PLANES


def image_off(got, want: torch.Tensor) -> float:
    """Share of u8 values of ``got`` more than 1 away from ``want``."""
    got = (got if torch.is_tensor(got) else torch.from_numpy(
        np.asarray(got))).to(want.device)
    if tuple(got.shape) != tuple(want.shape):
        return 1.0
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return float((diff > 1).double().mean())


def state_off(got: Dict, want: Dict, idx=None) -> float:
    """Share of the state planes' values beyond the tolerance;
    ``idx``: compare only these flat pixel indices of ``got``."""
    off = n = 0
    for k in PLANES:
        a, b = got[k], want[k]
        if idx is not None:
            a = a.reshape(*a.shape[:-2], -1)[..., idx]
        a = a.to(b.device)
        if tuple(a.shape) != tuple(b.shape):
            return 1.0
        tol = torch.clamp_min(b.abs(), STATE_FLOOR) * STATE_REL
        bad = ~((a - b).abs() <= tol)  # a NaN is off
        off += int(bad.sum())
        n += b.numel()
    return off / n


def fresh_state(width: int, height: int, device, n=None) -> Dict:
    """The state before a renderer's first frame: no history (its planes
    are never read), at ``n`` pixels or the whole frame."""
    shape = (n,) if n is not None else (height, width)
    return {"accum_color": torch.zeros((3, *shape), device=device),
            "accum_blend": torch.ones(shape, device=device),
            "old_depth": torch.full(shape, -1.0, device=device),
            "old_cam": np.zeros((4, 3), np.float32),
            "history_valid": False}


def ref_state(snap, width: int, height: int, device, idx=None) -> Dict:
    """The reference's starting state: the program's planes before the
    unit (at pixels ``idx``), the camera of the frame before it from the
    harness's traffic, live history; a fresh state where the unit has no
    state before it (the warm-up's)."""
    if snap.state_before is None:
        return fresh_state(width, height, device,
                           None if idx is None else int(idx.shape[0]))
    state = {}
    for k in PLANES:
        t = snap.state_before[k].to(device)
        if idx is not None:
            t = t.reshape(*t.shape[:-2], -1)[..., idx]
        state[k] = t
    state["old_cam"] = ref_frame.camera_rows(*snap.prev_pose, width, height)
    state["history_valid"] = True
    return state


def sun_params(yaw) -> ref_frame.RenderParams:
    """The reference's parameters of a frame at the sun's ``yaw`` (None:
    the default sun), the rest of them the defaults."""
    return ref_frame.RP if yaw is None else dataclasses.replace(
        ref_frame.RP, sun_yaw=yaw)


def frame_jobs(snap, width: int, height: int):
    """The camera rows, frame numbers and parameters of a unit's whole
    frames, each at the sun its traffic gave it."""
    cams = [ref_frame.camera_rows(p, d, width, height) for p, d in snap.cams]
    suns = snap.suns if snap.suns is not None else [None] * len(cams)
    return (cams, [snap.first_frame + j for j in range(len(cams))],
            [sun_params(y) for y in suns])


def compare_frames(tables, noise, snap, radius: int, traces,
                   lowp: bool = False):
    """A unit of consecutive whole frames (view, export), whose traces
    the reference has made (``traces``): the worst frame's
    ``image_off`` and the ``state_off`` after the last frame."""
    h, w = traces[0]["depth"].shape
    dev = tables.device
    cams, frames, params = frame_jobs(snap, w, h)
    images, states = ref_frame.render_frames(
        tables, noise, ref_state(snap, w, h, dev), cams, frames, radius,
        traces=traces, params=params)
    if lowp:
        got_images, got_state = ref_frame.render_frames(
            tables, noise, ref_state(snap, w, h, dev), cams, frames, radius,
            lowp=True, traces=traces, params=params)
        got_state = got_state[-1]
    else:
        got_images, got_state = snap.images, snap.state_after
    img = max(image_off(g, want) for g, want in zip(got_images, images))
    if len(got_images) < len(images):
        img = 1.0
    return {"image_off": img, "state_off": state_off(got_state, states[-1])}


def compare_burst(tables, noise, snap, n_frames: int, pixels: int,
                  seed: int, h: int, w: int, lowp: bool = False):
    """A burst of ``h`` x ``w`` frames at ``pixels`` pixels drawn from
    ``seed``: its last image and the state after it."""
    dev = tables.device
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(h * w, generator=g)[:pixels].to(dev)
    ys, xs = idx // w, idx % w
    cam = ref_frame.camera_rows(*snap.cams[0], w, h)
    frames = range(snap.first_frame, snap.first_frame + n_frames)
    image, state = ref_frame.burst_pixels(
        tables, noise, ref_state(snap, w, h, dev, idx), cam, frames, ys, xs)
    if lowp:
        got_img, got_state = ref_frame.burst_pixels(
            tables, noise, ref_state(snap, w, h, dev, idx), cam, frames, ys,
            xs, lowp=True)
        gidx = None
    else:
        got = torch.as_tensor(np.asarray(snap.images[0])).to(dev)
        got_img = got.reshape(-1, 3)[idx]
        got_state, gidx = snap.state_after, idx
    return {"image_off": image_off(got_img, image),
            "state_off": state_off(got_state, state, gidx)}


def worst(results: List[Dict], keys) -> Dict:
    """Each number's worst over the run's units; 1.0 where no unit was
    compared."""
    if not results:
        return {k: 1.0 for k in keys}
    return {k: max(r[k] for r in results) for k in keys}


def verdict(results: List[Dict], limits: Dict, expected: int):
    """``(numbers, correct, failed)`` of a run's units, against
    ``limits``: each number's worst (1.0 each where fewer than
    ``expected`` units were compared), whether each is within its
    limit, and how many units are not."""
    numbers = worst(results, limits)
    if len(results) < expected:
        numbers = {k: 1.0 for k in numbers}  # a unit was never kept
    correct = all(numbers[k] <= limits[k] for k in limits)
    failed = sum(any(r[k] > limits[k] for k in limits) for r in results)
    return numbers, correct, failed
