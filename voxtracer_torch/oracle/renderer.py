"""CPU oracle renderer — the golden definition of frame semantics.

A deliberately self-contained (numpy-only, no shared helpers) renderer
that reproduces the observable behaviour of the reference path-trace
kernel (``shaders/voxels.comp``): primary ray generation from the
pixel-scaled camera basis, exact voxel traversal, a 3-bounce integrator
with sun next-event estimation, specular/diffuse splitting, emissive
voxels and sky/sun-disk miss shading, producing the same G-buffer
channels (sample color, first-hit normal+depth, first-hit albedo and
packed node value, ``voxels.comp:394-396``).

It revives the role of the reference's orphaned CPU backend
(``src/cpu.rs``): a trustworthy host-side implementation used as the
differential-testing gold standard for the TPU kernels.

Traversal: the reference walks a sparse octree with an explicit stack
(``voxels.comp:134-247``); this oracle walks the dense grid with an
Amanatides-Woo DDA.  Both visit exactly the cells the ray passes
through, so hit results agree; the DDA honours the same 2048-step
safety fuse (``voxels.comp:166``) by returning an opaque black leaf.

Randomness: the reference advances one blue-noise slice per ``rand()``
call, with a branch-dependent number of calls per bounce
(``voxels.comp:268-275``).  For TPU-lane uniformity this engine instead
assigns a *fixed slot schedule*: 8 noise planes per bounce —
[specular-test, sun-axis x/y/z, sun dx, sun dy, hemisphere phi,
hemisphere x] — all renderers (oracle, XLA, Pallas) consume identical
planes, so they are bit-comparable while retaining the per-pixel
blue-noise property.

The port's copy of ``voxtracer/oracle/renderer.py``, which the port's
BASELINE harness (configs 1 and 6) holds the trace against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MAX_BOUNCES = 3
MAX_ITERATIONS = 2048
RANDS_PER_BOUNCE = 8
ALMOST_INFINITY = float(1 << 30)
CELL = 0.5
EMISSIVE_BIT = np.int32(np.uint32(1 << 30))
LEAF_BIT = np.int32(np.uint32(1 << 31))
RAY_EPS = 1e-5
# All geometry/shading runs in float32 so device kernels can match the
# oracle bit-for-bit on hit channels.
DTYPE = np.float32


# --------------------------------------------------------------------------
# Traversal
# --------------------------------------------------------------------------

def trace_rays(
    grid: np.ndarray,  # int32 [X, Y, Z]
    grid_origin: np.ndarray,  # int [3], voxel-lattice coord of cell (0,0,0)
    origins: np.ndarray,  # (N, 3) float
    dirs: np.ndarray,  # (N, 3) float, normalized
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """March every ray to its first occupied cell.

    Returns (hit (N,) bool, t (N,), value (N,) int32, normal (N,3)).
    """
    n = origins.shape[0]
    dims = np.array(grid.shape)
    world_lo = (grid_origin * CELL).astype(DTYPE)
    world_hi = ((grid_origin + dims) * CELL).astype(DTYPE)

    d = dirs.astype(DTYPE)
    o = origins.astype(DTYPE)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, 1.0 / d, np.inf)

    # Slab test against the grid bounding box.
    lo_t = (world_lo[None, :] - o) * inv_d
    hi_t = (world_hi[None, :] - o) * inv_d
    entry_per_axis = np.minimum(lo_t, hi_t)
    exit_per_axis = np.maximum(lo_t, hi_t)
    t_entry = entry_per_axis.max(axis=1)
    t_exit = exit_per_axis.min(axis=1)
    alive = (t_exit >= 0) & (t_entry < t_exit)

    t = np.maximum(DTYPE(0.0), t_entry)

    # Initial cell, with boundary points resolved along the direction of
    # travel (entering exactly at a face selects the cell ahead).
    p = o + t[:, None] * d
    cell_f = p / CELL - grid_origin[None, :]
    cell = np.floor(cell_f).astype(np.int64)
    on_boundary = cell_f == np.floor(cell_f)
    cell = np.where(on_boundary & (d < 0), cell - 1, cell)
    # Entry-point rounding may land an epsilon outside the box; clamp the
    # starting cell so intersecting rays always begin inside the grid.
    cell = np.clip(cell, 0, dims[None, :] - 1)

    step = np.where(d > 0, 1, np.where(d < 0, -1, 0)).astype(np.int64)

    hit = np.zeros(n, dtype=bool)
    value = np.zeros(n, dtype=np.int32)
    hit_t = np.zeros(n, dtype=DTYPE)
    hit_axis_sign = np.zeros((n, 3), dtype=DTYPE)
    hit_cell = np.zeros((n, 3), dtype=np.int64)

    for _ in range(MAX_ITERATIONS):
        if not alive.any():
            break
        in_bounds = ((cell >= 0) & (cell < dims[None, :])).all(axis=1)
        alive &= in_bounds

        idx = np.where(alive[:, None], cell, 0)
        val = grid[idx[:, 0], idx[:, 1], idx[:, 2]]
        found = alive & (val != 0)
        if found.any():
            hit[found] = True
            value[found] = val[found]
            hit_t[found] = t[found]
            hit_cell[found] = cell[found]
            alive &= ~found

        # Advance to the next cell boundary.
        next_bound = ((grid_origin[None, :] + cell + (step > 0)) * CELL).astype(DTYPE)
        t_axes = np.where(
            step != 0, (next_bound - o) * inv_d, np.inf
        )
        t_cross = t_axes.min(axis=1)
        axis = np.argmin(t_axes, axis=1)
        adv = np.zeros_like(cell)
        adv[np.arange(n), axis] = step[np.arange(n), axis]
        cell = np.where(alive[:, None], cell + adv, cell)
        t = np.where(alive, t_cross, t)
    else:
        # Safety fuse: surviving rays report an opaque black leaf, as the
        # reference does at 2048 iterations (voxels.comp:166-169).
        if alive.any():
            hit[alive] = True
            value[alive] = LEAF_BIT
            hit_t[alive] = t[alive]
            hit_cell[alive] = cell[alive]

    # Normal from the dominant axis of the hit point relative to the hit
    # cell's center, sign opposing the ray (voxels.comp:181-187).  Exact
    # ties set several components, as the shader's equal() mask does.
    p_hit = o + hit_t[:, None] * d
    center = ((grid_origin[None, :] + hit_cell + 0.5) * CELL).astype(DTYPE)
    dist = np.abs(p_hit - center)
    max_dist = dist.max(axis=1, keepdims=True)
    mask = dist == max_dist
    hit_axis_sign = np.where(mask, -np.sign(d), 0.0)
    hit_axis_sign[~hit] = 0.0

    return hit, hit_t, value, hit_axis_sign


# --------------------------------------------------------------------------
# Shading helpers
# --------------------------------------------------------------------------

def _node_color(node: np.ndarray) -> np.ndarray:
    v = node.astype(np.int64)
    return (
        np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], axis=-1)
        .astype(DTYPE)
        / DTYPE(255.0)
    )


def _node_emittance(node: np.ndarray, emit_strength: float) -> np.ndarray:
    emissive = (node.astype(np.int64) & int(np.uint32(1 << 30))) != 0
    return emissive[:, None] * DTYPE(emit_strength) * _node_color(node)


def _normalize(v: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.where(norm == 0, 1.0, norm)


def sun_direction(yaw: float, pitch: float) -> np.ndarray:
    """Direction sunlight travels (voxels.comp:296)."""
    return np.array(
        [
            np.cos(yaw) * np.cos(pitch),
            -np.sin(pitch),
            np.sin(yaw) * np.cos(pitch),
        ]
    )


# --------------------------------------------------------------------------
# Integrator
# --------------------------------------------------------------------------

def render_sample(
    grid: np.ndarray,
    grid_origin: np.ndarray,
    camera_origin: np.ndarray,
    camera_right: np.ndarray,
    camera_up: np.ndarray,
    camera_forward: np.ndarray,  # pixel-scaled (Camera.axis_scaled)
    params,
    noise_planes: np.ndarray,  # (>= 8*MAX_BOUNCES, H, W) in [0, 1)
    width: int,
    height: int,
    rng_order: str = "slots",
) -> Dict[str, np.ndarray]:
    """Render one 1-spp sample, returning the trace-stage G-buffer.

    ``rng_order`` selects the rand() consumption schedule:

    * ``"slots"`` (default): fixed 8 noise slices per bounce
      (spec test, 3 sun-frame, 2 sun-disk, 2 hemisphere) — the
      schedule all three renderers (oracle / XLA / Pallas) share, so
      they stay bit-comparable.
    * ``"reference"``: the reference's exact branch-dependent order
      (``voxels.comp:268-275``: one slice per CALL, and a specular
      bounce consumes 1 call where a diffuse one consumes 8) — used to
      QUANTIFY the schedule divergence.  With the default parameters
      (``specularity == 0``, sun on) every surviving bounce is diffuse
      and consumes exactly the same 8 slices in the same order, so the
      two schedules coincide bit-for-bit; they only diverge when
      ``specularity > 0`` (specular bounces skip 7 calls) or the sun
      is off (diffuse bounces skip 5).
    """
    camera_origin = np.asarray(camera_origin, DTYPE)
    camera_right = np.asarray(camera_right, DTYPE)
    camera_up = np.asarray(camera_up, DTYPE)
    camera_forward = np.asarray(camera_forward, DTYPE)
    noise_planes = np.asarray(noise_planes, DTYPE)

    px, py = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    px = px.ravel().astype(DTYPE)
    py = py.ravel().astype(DTYPE)
    n = px.size

    ray_dir = _normalize(
        px[:, None] * camera_right[None, :]
        - py[:, None] * camera_up[None, :]
        + camera_forward[None, :]
    )
    ray_origin = np.broadcast_to(camera_origin, (n, 3)).astype(DTYPE).copy()

    noise = noise_planes.reshape(noise_planes.shape[0], -1)
    seq_idx = np.zeros(n, np.int64)
    lane_ids = np.arange(n)

    def draw(k_fixed, mask):
        """One rand() value per pixel.  Slots mode reads the fixed
        slice; reference mode reads each pixel's NEXT sequential slice
        and advances only the pixels where the reference makes the
        call (its per-pixel call counter, voxels.comp:268-275)."""
        if rng_order != "reference":
            return noise[k_fixed]
        val = noise[np.minimum(seq_idx, noise.shape[0] - 1), lane_ids]
        seq_idx[:] = seq_idx + mask.astype(np.int64)
        return val

    sun_dir = sun_direction(params.sun_yaw, params.sun_pitch).astype(DTYPE)
    sun_color = (np.asarray(params.sun_color) * params.sun_strength).astype(DTYPE)
    sky_color = np.asarray(params.sky_color, dtype=DTYPE)

    sample_color = np.zeros((n, 3), DTYPE)
    blending = np.ones((n, 3), DTYPE)
    ambient_rays = np.ones(n, DTYPE)
    path_alive = np.ones(n, dtype=bool)

    first_node = np.full(n, 0xFFFFFF, dtype=np.int32)
    first_normal = np.full((n, 3), ALMOST_INFINITY, DTYPE)
    first_time = np.full(n, -1.0, DTYPE)

    for bounce in range(MAX_BOUNCES):
        k0 = RANDS_PER_BOUNCE * bounce
        hit, t, node, normal = trace_rays(
            grid, grid_origin, ray_origin, ray_dir
        )
        hit &= path_alive

        hit_pos = ray_origin + t[:, None] * ray_dir

        color = (
            np.ones((n, 3), DTYPE) if bounce == 0 else _node_color(node)
        )
        emittance = _node_emittance(node, params.emit_strength)

        if bounce == 0:
            first_node = np.where(hit, node, first_node)
            first_normal = np.where(hit[:, None], normal, first_normal)
            first_time = np.where(hit, t, first_time)

        specular = draw(k0, hit) < params.specularity
        diffuse_m = hit & ~specular

        # --- specular branch ---------------------------------------
        reflect = _normalize(
            ray_dir
            - 2.0 * np.sum(normal * ray_dir, axis=1, keepdims=True) * normal
        )
        spec_blend = (
            2.0
            * color
            * np.sum(reflect * normal, axis=1, keepdims=True)
        )

        # --- diffuse branch ----------------------------------------
        sun_contrib = np.zeros((n, 3), DTYPE)
        count_sun = False
        if params.sun_strength > 0:
            rand_dir = np.stack(
                [
                    draw(k0 + 1, diffuse_m),
                    draw(k0 + 2, diffuse_m),
                    draw(k0 + 3, diffuse_m),
                ],
                axis=1,
            )
            up_dir = _normalize(np.cross(rand_dir, sun_dir[None, :]))
            right_dir = _normalize(np.cross(sun_dir[None, :], up_dir))
            dx = 2.0 * draw(k0 + 4, diffuse_m) - 1.0
            dy = 2.0 * draw(k0 + 5, diffuse_m) - 1.0
            light_dir = _normalize(sun_dir)[None, :] + (
                dx[:, None] * right_dir + dy[:, None] * up_dir
            ) * params.sun_size
            shadow_dir = _normalize(-light_dir)
            shadow_origin = hit_pos + RAY_EPS * normal
            obstructed, _, _, _ = trace_rays(
                grid, grid_origin, shadow_origin, shadow_dir
            )
            cos_term = np.maximum(
                0.0, np.sum(normal * shadow_dir, axis=1)
            )
            sun_contrib = np.where(
                obstructed[:, None],
                0.0,
                sun_color[None, :] * color * blending * cos_term[:, None],
            )
            count_sun = True

        phi = 2.0 * np.pi * draw(k0 + 6, diffuse_m)
        hx = 2.0 * draw(k0 + 7, diffuse_m) - 1.0
        plane_r = np.sqrt(np.maximum(0.0, 1.0 - hx * hx))
        sphere = np.stack(
            [hx, plane_r * np.cos(phi), plane_r * np.sin(phi)], axis=1
        )
        ndot = np.sum(normal * sphere, axis=1, keepdims=True)
        hemi = sphere - normal * np.minimum(0.0, 2.0 * ndot)
        diff_blend = color * np.sum(normal * hemi, axis=1, keepdims=True)

        # --- merge branches for rays that hit ----------------------
        active_hit = hit
        spec_sel = specular & active_hit
        diff_sel = (~specular) & active_hit

        sample_color = np.where(
            active_hit[:, None], sample_color + emittance * blending, sample_color
        )
        if count_sun:
            sample_color = np.where(
                diff_sel[:, None], sample_color + sun_contrib, sample_color
            )
            ambient_rays = np.where(diff_sel, ambient_rays + 1, ambient_rays)

        new_blend = np.where(spec_sel[:, None], blending * spec_blend, blending)
        new_blend = np.where(diff_sel[:, None], blending * diff_blend, new_blend)
        blending = new_blend

        new_dir = np.where(spec_sel[:, None], reflect, ray_dir)
        new_dir = np.where(diff_sel[:, None], hemi, new_dir)
        new_origin = np.where(
            active_hit[:, None], hit_pos + RAY_EPS * normal, ray_origin
        )

        # --- miss: sky (+ sun disk on the primary ray) -------------
        miss = path_alive & ~hit
        if miss.any():
            if bounce == 0:
                sun_power = np.power(
                    np.maximum(
                        0.0,
                        np.sum(ray_dir * _normalize(-sun_dir)[None, :], axis=1),
                    ),
                    1.0 / max(params.sun_size**2, 1e-12),
                )
                sky = sky_color[None, :] + sun_color[None, :] * sun_power[:, None]
            else:
                sky = np.broadcast_to(sky_color[None, :], (n, 3))
            sample_color = np.where(
                miss[:, None], sample_color + sky * blending, sample_color
            )
        path_alive &= hit

        ray_origin = new_origin
        ray_dir = new_dir

    out_color = sample_color / ambient_rays[:, None]
    emissive_first = (first_node & EMISSIVE_BIT) != 0
    albedo = np.where(
        emissive_first[:, None], np.ones((n, 3), DTYPE), _node_color(first_node)
    )

    shape2 = (height, width)
    return {
        "color": out_color.reshape(height, width, 3).astype(np.float32),
        "normal": first_normal.reshape(height, width, 3).astype(np.float32),
        "depth": first_time.reshape(shape2).astype(np.float32),
        "albedo": albedo.reshape(height, width, 3).astype(np.float32),
        "node": first_node.reshape(shape2),
    }
