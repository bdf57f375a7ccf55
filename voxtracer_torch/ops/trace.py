"""The path-trace stage: 1 sample per pixel, 3 bounces, sun NEE.

Counterpart of ``voxtracer.ops.trace_pallas.render_sample`` (the Pallas
TPU kernel) and of its semantic twin ``voxtracer.ops.trace_xla``.  Three
functions:

* :func:`render_sample_plain` — plain torch ops, a lockstep vectorised
  walk over the same four scene tables the kernel reads (meta
  halfwords, brick masks, 10-bit fine slots), one DDA step per loop
  iteration (``trace_pallas._make_traverse``), the hit resolve
  (``finish``) and the shading of ``trace_pallas._make_kernel``.  It is
  the CPU path and the reference the CUDA kernel is held against.
* :func:`render_sample_cuda` — launches the hand-written kernel
  ``csrc/trace.cu``, a per-thread transcription of the same steps.
* :func:`render_sample` — picks one of the two by the tables' device.

Every float operation in the plain version is one torch op, in the
order the Pallas kernel writes it, so that the plain version and the
kernel (built without FMA contraction) agree bit for bit except where a
transcendental (exp, log, cos, sin) rounds differently on the card.

Outputs are planar: color/normal/albedo (3, H, W) f32, depth (H, W) f32,
node (H, W) i32, ``rays`` (6,) int64 — the rays entering each
traversal phase [b0, s0, b1, s1, b2, s2] (image pixels only) — and
``steps`` (6,) int64, the DDA steps those rays took (outer steps plus
advancing micro-DDA steps; :func:`_traverse`).  The kernel's output
also has ``slots`` (1,) int64: the lockstep step slots its warps spent
(see ``csrc/trace.cu``), so that ``steps / (32 * slots)`` is its SIMT
efficiency.

The live-lane decay (the reference's ``phasestats --decay``,
``trace_pallas.py:1322-1393``): :func:`render_sample_steps` adds
``steps_map`` (6, H, W) int32, each pixel's DDA steps per phase (0 where
its path never entered the phase), from the plain version or from the
kernel's steps-map instance; :func:`warp_decay` groups it into the
kernel's warps and forms each phase's curve (the same torch code for
both).
"""

from __future__ import annotations

import ctypes
import re
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..engine.params import (
    ROW_TRACE,
    TRACE_PARAMS_LEN,
    DeviceRow,
    check_params,
)
from ..engine.scene import TABLES, SceneTables

MAX_BOUNCES = 3
RANDS_PER_BOUNCE = 8
N_PHASES = 2 * MAX_BOUNCES
# Per-ray cap on outer DDA steps (box skips / brick visits); a ray still
# marching after it becomes an opaque black leaf (voxels.comp:166-169).
MAX_RAY_STEPS = 2048
# Fine-cell steps of the in-brick micro-DDA per outer step.
MICRO_STEPS = 5
CELL_SIZE = 0.5
RAY_EPS = 1e-5
ALMOST_INFINITY = float(1 << 30)
LEAF_BIT = -(1 << 31)
EMISSIVE_BIT = 1 << 30
MISS_NODE = 0xFFFFFF
NOISE_SIZE = 128
# 2 * pi rounded as the Pallas kernel rounds it: (2.0 * float32(pi)) in f32
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))
# The CUDA kernel's counters: rays, steps (one per phase each), slots.
N_COUNTERS = 2 * N_PHASES + 1
# Rows of a band of the cyclic slab layout: csrc/trace.cu's BLOCK_Y, a
# row of the kernel's blocks.
BLOCK_ROWS = 16
# csrc/trace.cu's blocks are BLOCK_COLS x BLOCK_ROWS threads; a warp is
# 32 consecutive thread ids, two rows of a block.
BLOCK_COLS = 16
WARP = 32
# The live-decay thresholds (trace_pallas.py:694): a trip counts towards
# column f when at least max(1, ceil(f * 32)) of the warp's lanes are live.
DECAY_FRACS = (0.75, 0.5, 0.25, 0.125, 0.03125)
DECAY_COLUMNS = ("t75", "t50", "t25", "t12", "t03")

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def as_f32(x) -> float:
    """A Python float holding ``x`` rounded to float32 (scalar
    arithmetic on parameters must round as the kernel's does)."""
    return float(np.float32(x))


def sqrt_f32(x):
    """Correctly rounded float32 square root (as CUDA's sqrtf, which
    torch uses on the card).  torch's CPU sqrt of a large float32 tensor
    goes through a vector math library that is not correctly rounded;
    via float64 the result is."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _norm_div3(x, y, z):
    n = sqrt_f32(x * x + y * y + z * z)
    return x / n, y / n, z / n


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _div(a, s: float):
    """a / s rounded as IEEE division: torch's CUDA kernel would multiply
    by the reciprocal of a Python-scalar divisor instead."""
    return a / a.new_full((), s)


def _max0(a, s: float):
    """NaN-propagating max against a scalar (jnp.maximum semantics)."""
    return torch.maximum(a, a.new_full((), s))


def _min0(a, s: float):
    return torch.minimum(a, a.new_full((), s))


def _traverse(tab: SceneTables, o: Vec3, d: Vec3, mask: torch.Tensor,
              ray_steps: Optional[torch.Tensor] = None):
    """March rays over the table hierarchy to their first occupied cell.

    Returns (hit bool, t f32, slot i32, fused bool, (nx, ny, nz) f32),
    one entry per ray, and ``steps``: a 0-dim int64 tensor, the DDA
    steps these rays took — one per outer step (a meta-word visit of a
    ray inside the grid) and one per fine cell the micro-DDA advanced.
    Rays finished early leave the working set, so each loop iteration
    costs only the rays still marching.  ``ray_steps`` (one int32 entry
    per ray, zeroed), where given, receives each ray's own steps.
    """
    X, Y, Z = tab.dims
    oxi, oyi, ozi = tab.origin
    ogx, ogy, ogz = float(oxi), float(oyi), float(ozi)
    QX, QY, QZ = tab.l3_dims
    QZW2 = -(-QZ // 2)
    QY4 = -(-QY // 4)
    PY4 = -(-Y // 4)
    meta = tab.meta_idx.reshape(-1)
    brick = tab.brick_idx.reshape(tab.brick_idx.shape[0], -1)
    packed = tab.packed_idx.reshape(-1)
    inf = float("inf")

    ox, oy, oz = o
    dx, dy, dz = d
    n = ox.shape[0]
    dev = ox.device
    i32 = torch.int32

    invx = torch.where(dx != 0.0, 1.0 / dx, inf)
    invy = torch.where(dy != 0.0, 1.0 / dy, inf)
    invz = torch.where(dz != 0.0, 1.0 / dz, inf)

    def slab(lo, hi, oo, inv):
        a = (lo - oo) * inv
        b = (hi - oo) * inv
        return torch.minimum(a, b), torch.maximum(a, b)

    enx, exx = slab(oxi * CELL_SIZE, (oxi + X) * CELL_SIZE, ox, invx)
    eny, exy = slab(oyi * CELL_SIZE, (oyi + Y) * CELL_SIZE, oy, invy)
    enz, exz = slab(ozi * CELL_SIZE, (ozi + Z) * CELL_SIZE, oz, invz)
    t_entry = torch.maximum(torch.maximum(enx, eny), enz)
    t_exit = torch.minimum(torch.minimum(exx, exy), exz)
    intersects = (t_exit >= 0.0) & (t_entry < t_exit)

    def cell_from_float(oo, dd, t, og):
        p = oo + t * dd
        cf = p / CELL_SIZE - og
        c = torch.floor(cf)
        return torch.where((cf == c) & (dd < 0), c - 1.0, c).to(i32)

    def bt_axis(lo, hi, og, sgn, oo, inv):
        bnd = torch.where(sgn > 0, hi, lo)
        nb = (og + bnd.to(torch.float32)) * CELL_SIZE
        return torch.where(sgn != 0, (nb - oo) * inv, inf)

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    fused = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_t = torch.zeros(n, dtype=torch.float32, device=dev)
    hslot_u = torch.zeros(n, dtype=i32, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    hcx = torch.zeros(n, dtype=i32, device=dev)
    hcy = torch.zeros_like(hcx)
    hcz = torch.zeros_like(hcx)

    ids = torch.nonzero(intersects & mask).squeeze(1)
    # working set, one entry per marching ray
    r_o = [v[ids] for v in (ox, oy, oz)]
    r_d = [v[ids] for v in (dx, dy, dz)]
    r_inv = [v[ids] for v in (invx, invy, invz)]
    r_s = [torch.sign(v).to(i32) for v in r_d]
    t = _max0(t_entry[ids], 0.0)
    cx = torch.clamp(cell_from_float(r_o[0], r_d[0], t, ogx), 0, X - 1)
    cy = torch.clamp(cell_from_float(r_o[1], r_d[1], t, ogy), 0, Y - 1)
    cz = torch.clamp(cell_from_float(r_o[2], r_d[2], t, ogz), 0, Z - 1)

    def keep_only(keep):
        nonlocal ids, r_o, r_d, r_inv, r_s, t, cx, cy, cz
        ids = ids[keep]
        r_o = [v[keep] for v in r_o]
        r_d = [v[keep] for v in r_d]
        r_inv = [v[keep] for v in r_inv]
        r_s = [v[keep] for v in r_s]
        t, cx, cy, cz = t[keep], cx[keep], cy[keep], cz[keep]

    for _ in range(MAX_RAY_STEPS):
        if ids.numel() == 0:
            break
        # 1. bounds check: a ray that left the grid misses
        inb = (
            (cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & (cz >= 0)
            & (cz < Z)
        )
        if not bool(inb.all()):
            keep_only(inb)
            if ids.numel() == 0:
                break
        (rox, roy, roz), (rdx, rdy, rdz) = r_o, r_d
        (rix, riy, riz), (sx, sy, sz) = r_inv, r_s
        steps += ids.numel()
        if ray_steps is not None:
            ray_steps[ids] += 1

        # 2. the node's 16-bit meta halfword
        qx, qy, qz = cx >> 2, cy >> 2, cz >> 2
        l3_col = ((qx >> 2) * QY4 + (qy >> 2)) * 16 + ((qx & 3) << 2) + (
            qy & 3
        )
        m_word = meta[(l3_col * QZW2 + (qz >> 1)).long()]
        val = (m_word >> ((qz & 1) << 4)) & 0xFFFF
        occ = (val & 0x8000) != 0

        # 3. occupied node: its 64-bit brick mask (+ uniform slot)
        if tab.brick_dedup:
            baddr = torch.where(occ, val & 0x7FFF, 0).long()
            b_slot = brick[2][baddr]
        else:
            baddr = torch.where(occ, l3_col * QZ + qz, 0).long()
            b_slot = val & 0x3FF
        b_lo = brick[0][baddr]
        b_hi = brick[1][baddr]

        def brick_bit(cx_, cy_, cz_):
            cxm = cx_ & 3
            w = torch.where(cxm < 2, b_lo, b_hi)
            bitk = ((cxm & 1) << 4) | ((cy_ & 3) << 2) | (cz_ & 3)
            return ((w >> bitk) & 1) == 1

        def in_node(cx_, cy_, cz_):
            return ((cx_ >> 2) == qx) & ((cy_ >> 2) == qy) & (
                (cz_ >> 2) == qz
            )

        # 4a. micro-DDA over the brick's fine cells: stop on a set bit
        # or on leaving the node
        run = occ.clone()
        for _ in range(MICRO_STEPS):
            run = run & ~brick_bit(cx, cy, cz)
            steps += run.sum()
            if ray_steps is not None:
                ray_steps[ids] += run.to(i32)
            btx = bt_axis(cx, cx + 1, ogx, sx, rox, rix)
            bty = bt_axis(cy, cy + 1, ogy, sy, roy, riy)
            btz = bt_axis(cz, cz + 1, ogz, sz, roz, riz)
            bt = torch.minimum(torch.minimum(btx, bty), btz)
            bsx = (btx <= bty) & (btx <= btz)
            bsy = (~bsx) & (bty <= btz)
            bsz = (~bsx) & (~bsy)
            cx = cx + torch.where(run & bsx, sx, 0)
            cy = cy + torch.where(run & bsy, sy, 0)
            cz = cz + torch.where(run & bsz, sz, 0)
            t = torch.where(run, torch.maximum(t, bt), t)
            run = run & in_node(cx, cy, cz)
        found = occ & in_node(cx, cy, cz) & brick_bit(cx, cy, cz)

        # 4b. empty node: its distance d certifies the node box
        # [(q-d+1)*4, (q+d)*4) empty; exit the box on the crossing axis,
        # the other axes follow the ray
        empty = ~occ
        dist = torch.clamp_min(val & 0x1FF, 1)
        lox, hix = (qx - dist + 1) * 4, (qx + dist) * 4
        loy, hiy = (qy - dist + 1) * 4, (qy + dist) * 4
        loz, hiz = (qz - dist + 1) * 4, (qz + dist) * 4
        btx = bt_axis(lox, hix, ogx, sx, rox, rix)
        bty = bt_axis(loy, hiy, ogy, sy, roy, riy)
        btz = bt_axis(loz, hiz, ogz, sz, roz, riz)
        bt = torch.minimum(torch.minimum(btx, bty), btz)
        bsx = (btx <= bty) & (btx <= btz)
        bsy = (~bsx) & (bty <= btz)
        jx = torch.where(sx > 0, hix, lox - 1)
        jy = torch.where(sy > 0, hiy, loy - 1)
        jz = torch.where(sz > 0, hiz, loz - 1)
        fxc = cell_from_float(rox, rdx, bt, ogx)
        fyc = cell_from_float(roy, rdy, bt, ogy)
        fzc = cell_from_float(roz, rdz, bt, ogz)
        cx = torch.where(empty, torch.where(bsx, jx, fxc), cx)
        cy = torch.where(empty, torch.where(bsy, jy, fyc), cy)
        cz = torch.where(empty, torch.where(~bsx & ~bsy, jz, fzc), cz)
        t = torch.where(empty, torch.maximum(t, bt), t)

        if bool(found.any()):
            fid = ids[found]
            hit[fid] = True
            hit_t[fid] = t[found]
            hcx[fid], hcy[fid], hcz[fid] = cx[found], cy[found], cz[found]
            hslot_u[fid] = b_slot[found]
            keep_only(~found)
    else:
        # step cap: still-marching rays become opaque black leaves at
        # their current cell (checked after the last step, before any
        # bounds test, exactly where the Pallas kernel checks it)
        hit[ids] = True
        fused[ids] = True
        hit_t[ids] = t
        hcx[ids], hcy[ids], hcz[ids] = cx, cy, cz

    # hit resolve: uniform nodes carried their slot; mixed ones read the
    # 3-slots-per-word fine table at the hit cell
    need = hit & ~fused & (hslot_u == 0)
    fzw = torch.div(hcz, 3, rounding_mode="floor")
    fcol = ((hcx >> 2) * PY4 + (hcy >> 2)) * 16 + ((hcx & 3) << 2) + (
        hcy & 3
    )
    fword = packed[torch.where(need, fcol * tab.zw + fzw, 0).long()]
    slot = torch.where(
        need, (fword >> ((hcz - fzw * 3) * 10)) & 1023, hslot_u
    )
    slot = torch.where(hit & ~fused, slot, 0)

    # normal: dominant axis of (hit point - cell center), opposing the
    # ray; exact ties set several components
    px = ox + hit_t * dx
    py = oy + hit_t * dy
    pz = oz + hit_t * dz
    ccx = (ogx + hcx.to(torch.float32)) * CELL_SIZE + 0.5 * CELL_SIZE
    ccy = (ogy + hcy.to(torch.float32)) * CELL_SIZE + 0.5 * CELL_SIZE
    ccz = (ogz + hcz.to(torch.float32)) * CELL_SIZE + 0.5 * CELL_SIZE
    ax = torch.abs(px - ccx)
    ay = torch.abs(py - ccy)
    az = torch.abs(pz - ccz)
    m = torch.maximum(torch.maximum(ax, ay), az)
    nx = torch.where((ax == m) & hit, -torch.sign(dx), 0.0)
    ny = torch.where((ay == m) & hit, -torch.sign(dy), 0.0)
    nz = torch.where((az == m) & hit, -torch.sign(dz), 0.0)
    return hit, hit_t, slot, fused, (nx, ny, nz), steps


def _node_rgb(node):
    r = _div(((node >> 16) & 0xFF).to(torch.float32), 255.0)
    g = _div(((node >> 8) & 0xFF).to(torch.float32), 255.0)
    b = _div((node & 0xFF).to(torch.float32), 255.0)
    return r, g, b


def _check_inputs(tables, noise, height, width):
    if noise.dtype != torch.float32 or noise.dim() != 3 or tuple(
        noise.shape[1:]
    ) != (NOISE_SIZE, NOISE_SIZE):
        raise ValueError(
            f"noise must be (S, {NOISE_SIZE}, {NOISE_SIZE}) float32, got "
            f"{tuple(noise.shape)} {noise.dtype}"
        )
    if noise.device != tables.device:
        raise ValueError(
            f"noise on {noise.device}, scene tables on {tables.device}"
        )
    if height <= 0 or width <= 0:
        raise ValueError(f"invalid size {width}x{height}")


def image_rows(height: int, row0: int = 0, row_stride: int = 1) -> np.ndarray:
    """The image rows that a trace of ``height`` rows renders: its local
    row y, in band ``y // B`` of B = :data:`BLOCK_ROWS` rows, renders
    ``(y // B) * row_stride * B + row0 + y % B`` (csrc/trace.cu: a band
    is a row of its blocks).  With ``row_stride`` 1 that is ``row0 + y``,
    a contiguous slab; with ``row_stride`` n and ``row0 = c * B``, every
    n-th band from band c on (the cyclic layout of
    ``voxtracer_torch.parallel.mesh``)."""
    y = np.arange(height, dtype=np.int64)
    return (y // BLOCK_ROWS) * row_stride * BLOCK_ROWS + row0 + y % BLOCK_ROWS


def pixel_rows(height: int, row0: int, device) -> torch.Tensor:
    """(height, 1) float32: the image rows ``row0 .. row0 + height - 1``
    of a slab's pixels, exact (integers below 2^24)."""
    return (torch.arange(height, device=device) + row0).to(
        torch.float32)[:, None]


def _check_rows(row0, row_stride):
    if row0 < 0 or row_stride < 1:
        raise ValueError(f"invalid rows: row0 {row0}, row_stride "
                         f"{row_stride}")


def render_sample_plain(
    tables: SceneTables,
    params: np.ndarray,  # (32,) f32, engine.params.pack_trace_params
    noise: torch.Tensor,  # (S, 128, 128) f32
    frame: int,
    height: int,
    width: int,
    row0: int = 0,
    row_stride: int = 1,
    steps_map: bool = False,
) -> Dict[str, torch.Tensor]:
    """One path-traced sample per pixel with plain torch ops, for the
    ``height`` image rows of :func:`image_rows` (``row0`` and
    ``row_stride``: a slab of a row-sharded frame; by default the rows
    ``0 .. height - 1``).  ``steps_map``: also each pixel's steps per
    phase, (6, height, width) int32 (:func:`render_sample_steps`)."""
    _check_inputs(tables, noise, height, width)
    _check_rows(row0, row_stride)
    # exact float32 values
    P = [float(v) for v in check_params(params, TRACE_PARAMS_LEN)]
    dev = tables.device
    f32 = torch.float32
    n = height * width
    n_slices = noise.shape[0]
    frame = int(frame) % n_slices

    # each local row's image row: ray generation and the noise row
    yy, xx = torch.meshgrid(
        torch.from_numpy(image_rows(height, row0, row_stride)).to(dev),
        torch.arange(width, device=dev),
        indexing="ij",
    )
    xx, yy = xx.reshape(n), yy.reshape(n)
    pix = ((yy % NOISE_SIZE) * NOISE_SIZE + (xx % NOISE_SIZE)).long()
    flat_noise = noise.reshape(n_slices, -1)

    def rnd(k):
        return flat_noise[(frame + 1 + k) % n_slices][pix]

    palette = tables.palette.reshape(-1)
    px, py = xx.to(f32), yy.to(f32)
    rdx = px * P[3] - py * P[6] + P[9]
    rdy = px * P[4] - py * P[7] + P[10]
    rdz = px * P[5] - py * P[8] + P[11]
    rdx, rdy, rdz = _norm_div3(rdx, rdy, rdz)
    zf = torch.zeros(n, dtype=f32, device=dev)
    rox, roy, roz = zf + P[0], zf + P[1], zf + P[2]

    sun_size, sun_strength = P[14], P[15]
    emit, specularity = P[16], P[17]
    sun_col = [as_f32(np.float32(P[18 + i]) * np.float32(sun_strength))
               for i in range(3)]
    sky = P[21:24]
    sdx, sdy, sdz = P[24:27]
    nsx, nsy, nsz = P[27:30]
    sun_on = sun_strength > 0.0
    glow_div = as_f32(max(np.float32(sun_size) * np.float32(sun_size),
                        np.float32(1e-12)))

    sample = [zf.clone() for _ in range(3)]
    blend = [zf + 1.0 for _ in range(3)]
    ambient = zf + 1.0
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    first_node = torch.full((n,), MISS_NODE, dtype=torch.int32, device=dev)
    first_n = [zf + ALMOST_INFINITY for _ in range(3)]
    first_t = zf - 1.0
    rays = torch.zeros(N_PHASES, dtype=torch.int64, device=dev)
    steps = torch.zeros(N_PHASES, dtype=torch.int64, device=dev)
    smap = (torch.zeros((N_PHASES, n), dtype=torch.int32, device=dev)
            if steps_map else None)

    def walk(o, d, mask, phase):
        if smap is None:
            return _traverse(tables, o, d, mask)
        return _traverse(tables, o, d, mask, ray_steps=smap[phase])

    for bounce in range(MAX_BOUNCES):
        k0 = RANDS_PER_BOUNCE * bounce
        rays[2 * bounce] = alive.sum()
        hit_i, t, slot, fused, (nx, ny, nz), steps[2 * bounce] = walk(
            (rox, roy, roz), (rdx, rdy, rdz), alive, 2 * bounce
        )
        hit = hit_i & alive
        node = torch.where(fused, LEAF_BIT, palette[slot.long()])
        hx = rox + t * rdx
        hy = roy + t * rdy
        hz = roz + t * rdz
        cr, cg, cb = _node_rgb(node)
        col = (zf + 1.0,) * 3 if bounce == 0 else (cr, cg, cb)
        emissive = ((node & EMISSIVE_BIT) != 0).to(f32)
        for c, cc in enumerate((cr, cg, cb)):
            sample[c] = sample[c] + torch.where(
                hit, emissive * emit * cc * blend[c], 0.0
            )
        if bounce == 0:
            first_node = torch.where(hit, node, first_node)
            first_n = [torch.where(hit, v, f) for v, f in
                       zip((nx, ny, nz), first_n)]
            first_t = torch.where(hit, t, first_t)

        specular = rnd(k0) < specularity

        # specular reflection
        ddn = _dot3(nx, ny, nz, rdx, rdy, rdz)
        rfx, rfy, rfz = _norm_div3(
            rdx - 2.0 * ddn * nx, rdy - 2.0 * ddn * ny, rdz - 2.0 * ddn * nz
        )
        spec_dot = _dot3(rfx, rfy, rfz, nx, ny, nz)

        # sun next-event estimation: a jittered direction in the sun disk
        rdax, rday, rdaz = rnd(k0 + 1), rnd(k0 + 2), rnd(k0 + 3)
        upx, upy, upz = _norm_div3(
            rday * sdz - rdaz * sdy,
            rdaz * sdx - rdax * sdz,
            rdax * sdy - rday * sdx,
        )
        rix, riy, riz = _norm_div3(
            sdy * upz - sdz * upy,
            sdz * upx - sdx * upz,
            sdx * upy - sdy * upx,
        )
        ddx = 2.0 * rnd(k0 + 4) - 1.0
        ddy = 2.0 * rnd(k0 + 5) - 1.0
        ldx = nsx + (ddx * rix + ddy * upx) * sun_size
        ldy = nsy + (ddx * riy + ddy * upy) * sun_size
        ldz = nsz + (ddx * riz + ddy * upz) * sun_size
        shx, shy, shz = _norm_div3(-ldx, -ldy, -ldz)
        sox = hx + RAY_EPS * nx
        soy = hy + RAY_EPS * ny
        soz = hz + RAY_EPS * nz
        # the shadow ray is skipped where the sun is behind the surface:
        # its contribution is cos_term-clamped to zero regardless
        cos_term = _max0(_dot3(nx, ny, nz, shx, shy, shz), 0.0)
        s_mask = hit & (~specular) & sun_on & (cos_term > 0.0)

        # cosine-free hemisphere sample
        phi = TWO_PI * rnd(k0 + 6)
        hxs = 2.0 * rnd(k0 + 7) - 1.0
        pr = sqrt_f32(_max0(1.0 - hxs * hxs, 0.0))
        spx, spy, spz = hxs, pr * torch.cos(phi), pr * torch.sin(phi)
        flip = _min0(2.0 * _dot3(nx, ny, nz, spx, spy, spz), 0.0)
        hmx, hmy, hmz = spx - nx * flip, spy - ny * flip, spz - nz * flip
        diff_dot = _dot3(nx, ny, nz, hmx, hmy, hmz)

        spec_sel = specular & hit
        diff_sel = (~specular) & hit
        ambient = ambient + (diff_sel & sun_on).to(f32)

        # sky on a miss, with the sun disk on the primary ray only
        if bounce == 0:
            base = _max0(_dot3(rdx, rdy, rdz, -nsx, -nsy, -nsz), 1e-38)
            glow = torch.exp(_div(torch.log(base), glow_div))
            sky_c = [sky[c] + sun_col[c] * glow for c in range(3)]
        else:
            sky_c = [zf + sky[c] for c in range(3)]

        # the sun add uses this bounce's blend from before its update
        lt_blend = list(blend)
        bf_spec = 2.0 * spec_dot
        for c in range(3):
            blend[c] = torch.where(
                spec_sel,
                blend[c] * col[c] * bf_spec,
                torch.where(diff_sel, blend[c] * col[c] * diff_dot, blend[c]),
            )
        miss = alive & ~hit
        for c in range(3):
            sample[c] = sample[c] + torch.where(miss, sky_c[c] * blend[c], 0.0)
        alive = alive & hit
        rdx = torch.where(spec_sel, rfx, torch.where(diff_sel, hmx, rdx))
        rdy = torch.where(spec_sel, rfy, torch.where(diff_sel, hmy, rdy))
        rdz = torch.where(spec_sel, rfz, torch.where(diff_sel, hmz, rdz))
        rox = torch.where(hit, sox, rox)
        roy = torch.where(hit, soy, roy)
        roz = torch.where(hit, soz, roz)

        rays[2 * bounce + 1] = s_mask.sum()
        obst, _, _, _, _, steps[2 * bounce + 1] = walk(
            (sox, soy, soz), (shx, shy, shz), s_mask, 2 * bounce + 1
        )
        sun_gate = diff_sel & ~obst & sun_on
        for c in range(3):
            sample[c] = sample[c] + torch.where(
                sun_gate, sun_col[c] * col[c] * lt_blend[c] * cos_term, 0.0
            )

    emiss_first = (first_node & EMISSIVE_BIT) != 0
    alb = [torch.where(emiss_first, 1.0, v) for v in _node_rgb(first_node)]

    def planes(vs):
        return torch.stack(vs).reshape(3, height, width)

    out = {
        "color": planes([s / ambient for s in sample]),
        "normal": planes(first_n),
        "depth": first_t.reshape(height, width),
        "albedo": planes(alb),
        "node": first_node.reshape(height, width),
        "rays": rays,
        "steps": steps,
    }
    if steps_map:
        out["steps_map"] = smap.reshape(N_PHASES, height, width)
    return out


def render_sample_cuda(
    tables: SceneTables,
    params,  # (32,) f32 vector, or a frame's DeviceRow
    noise: torch.Tensor,
    frame,  # int; ignored with a DeviceRow, which holds the frame number
    height: int,
    width: int,
    row0: int = 0,
    row_stride: int = 1,
) -> Dict[str, torch.Tensor]:
    """The same sample from the hand-written CUDA kernel (csrc/trace.cu),
    for the image rows of :func:`image_rows` (passed by value).

    ``params`` is the host's vector, passed by value with ``frame``, or
    a :class:`~voxtracer_torch.engine.params.DeviceRow`: the kernel's
    row-reading entry then takes vector and frame number from the row on
    the device, so that a captured CUDA graph renders whichever row is
    there at replay.  Launches on the current stream and does
    not synchronise.  Raises if an input is not what the kernel takes or
    the launch is refused."""
    if not isinstance(params, DeviceRow):
        params = check_params(params, TRACE_PARAMS_LEN)
    counters, out = _cuda_outputs(tables, noise, height, width, row0,
                                  row_stride)
    from . import _build

    launch = _build.load().vt_trace_launch
    dev = tables.device
    geometry = tables.geometry()
    n_slices = int(noise.shape[0])
    if isinstance(params, DeviceRow):
        if params.row.device != dev:
            raise ValueError(
                f"row on {params.row.device}, scene tables on {dev}")
        # the vector and, behind it, the frame number
        source = (None, params.pointer(ROW_TRACE))
        frame = 0
    else:
        source = (params.ctypes.data, None)
        frame = int(frame) % n_slices
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *source,
            geometry.ctypes.data,
            tables.packed_idx.data_ptr(),
            tables.meta_idx.data_ptr(),
            tables.brick_idx.data_ptr(),
            tables.palette.data_ptr(),
            noise.data_ptr(),
            n_slices,
            frame,
            height,
            width,
            row0,
            row_stride,
            out["color"].data_ptr(),
            out["normal"].data_ptr(),
            out["albedo"].data_ptr(),
            out["depth"].data_ptr(),
            out["node"].data_ptr(),
            counters.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
    render_sample_cuda.launches += 1
    return out


render_sample_cuda.launches = 0


def _cuda_outputs(tables, noise, height, width, row0, row_stride):
    """Checks a kernel launch's inputs; ``(counters, out)``: the zeroed
    counters (rays 6, steps 6, slots 1) and the output dict, allocated on
    the tables' device."""
    _check_inputs(tables, noise, height, width)
    _check_rows(row0, row_stride)
    if tables.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {tables.device}")
    if not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    for name in TABLES:
        buf = getattr(tables, name)
        if buf.dtype != torch.int32 or not buf.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    dev = tables.device
    f32 = torch.float32
    # rays (6), steps (6) and slots (1) in one zeroed allocation
    counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)
    return counters, {
        "color": torch.empty((3, height, width), dtype=f32, device=dev),
        "normal": torch.empty((3, height, width), dtype=f32, device=dev),
        "depth": torch.empty((height, width), dtype=f32, device=dev),
        "albedo": torch.empty((3, height, width), dtype=f32, device=dev),
        "node": torch.empty((height, width), dtype=torch.int32, device=dev),
        "rays": counters[:N_PHASES],
        "steps": counters[N_PHASES:2 * N_PHASES],
        "slots": counters[2 * N_PHASES:],
    }


def render_sample_steps_cuda(
    tables: SceneTables,
    params: np.ndarray,  # (32,) f32, by value
    noise: torch.Tensor,
    frame: int,
    height: int,
    width: int,
    row0: int = 0,
    row_stride: int = 1,
) -> Dict[str, torch.Tensor]:
    """:func:`render_sample_cuda`'s by-value sample from the kernel's
    steps-map instance, which also writes ``steps_map``: each pixel's
    DDA steps per phase, (6, height, width) int32.  Counts its own
    launches (``render_sample_steps_cuda.launches``); launches on the
    current stream and does not synchronise."""
    params = check_params(params, TRACE_PARAMS_LEN)
    if N_PHASES * height * width >= 1 << 31:
        raise ValueError(f"steps map of {width}x{height} past int32 offsets")
    counters, out = _cuda_outputs(tables, noise, height, width, row0,
                                  row_stride)
    from . import _build

    launch = _build.load().vt_trace_steps_launch
    dev = tables.device
    out["steps_map"] = torch.zeros((N_PHASES, height, width),
                                   dtype=torch.int32, device=dev)
    n_slices = int(noise.shape[0])
    with torch.cuda.device(dev):
        err = launch(
            params.ctypes.data, tables.geometry().ctypes.data,
            tables.packed_idx.data_ptr(), tables.meta_idx.data_ptr(),
            tables.brick_idx.data_ptr(), tables.palette.data_ptr(),
            noise.data_ptr(), n_slices, int(frame) % n_slices, height, width,
            row0, row_stride, out["color"].data_ptr(),
            out["normal"].data_ptr(), out["albedo"].data_ptr(),
            out["depth"].data_ptr(), out["node"].data_ptr(),
            counters.data_ptr(), out["steps_map"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"trace steps-map launch failed: cudaError {err}")
    render_sample_steps_cuda.launches += 1
    return out


render_sample_steps_cuda.launches = 0


def render_sample_steps(tables: SceneTables, params, noise, frame,
                        height: int, width: int, row0: int = 0,
                        row_stride: int = 1) -> Dict[str, torch.Tensor]:
    """:func:`render_sample` with ``steps_map`` (6, height, width) int32,
    each pixel's DDA steps per phase: the plain version for CPU tensors,
    the kernel's steps-map instance for CUDA tensors."""
    args = (tables, params, noise, frame, height, width, row0, row_stride)
    kind = tables.device.type
    if kind == "cpu":
        return render_sample_plain(*args, steps_map=True)
    if kind == "cuda":
        return render_sample_steps_cuda(*args)
    raise ValueError(f"no trace implementation for device {tables.device}")


def warp_lanes(steps_map: torch.Tensor) -> torch.Tensor:
    """(P, n_warps, 32) int64: a (P, H, W) per-pixel map grouped into the
    trace kernel's warps (``csrc/trace.cu``: 16x16 blocks over the
    launch's local rows, a warp two rows of a block), lanes past the
    image's right or bottom edge 0 (they trace nothing)."""
    p, h, w = steps_map.shape
    hp = -(-h // BLOCK_ROWS) * BLOCK_ROWS
    wp = -(-w // BLOCK_COLS) * BLOCK_COLS
    m = torch.zeros((p, hp, wp), dtype=torch.int64, device=steps_map.device)
    m[:, :h, :w] = steps_map
    rows = WARP // BLOCK_COLS
    return m.reshape(p, hp // BLOCK_ROWS, BLOCK_ROWS // rows, rows,
                     wp // BLOCK_COLS, BLOCK_COLS).permute(
        0, 1, 4, 2, 3, 5).reshape(p, -1, WARP)


def decay_sums(steps_map: torch.Tensor) -> torch.Tensor:
    """(P, 1 + len(DECAY_FRACS)) int64 on the map's device: per phase,
    the sum over warps of the largest lane's steps (the warp's trips, as
    ``slots`` counts them) and, for each threshold k_f =
    max(1, ceil(f * 32)), of the k_f-th largest lane's steps (the trips
    on which at least k_f lanes were live)."""
    ks = [max(1, math.ceil(f * WARP)) for f in DECAY_FRACS]
    ranked = warp_lanes(steps_map).sort(dim=-1, descending=True).values
    return ranked[..., [0] + [k - 1 for k in ks]].sum(dim=1)


def warp_decay(steps_map: torch.Tensor):
    """The live-lane decay curve of each phase of a (6, H, W) steps map:
    a list of dicts ``{"trips", "t75", "t50", "t25", "t12", "t03"}``,
    t_f = sum over warps of the k_f-th largest lane's steps over the sum
    of the largest (:func:`decay_sums`): the share of a phase's warp
    trips on which at least a fraction f of the lanes were still
    marching (0.0 for a phase without steps).

    Not the reference's statistic: its t_f is the mean over tiles of a
    ratio, and a TPU tile's lanes refill from ray queues, so its trips
    are not one lane's steps.  Here a warp's lanes march in lockstep and
    a lane with no ray in the phase counts 0 steps; a ratio of integer
    sums, so the kernel's map and the plain version's compare exactly."""
    rows = []
    for sums in decay_sums(steps_map).tolist():
        trips = sums[0]
        rows.append({"trips": trips, **{
            c: (v / trips if trips else 0.0)
            for c, v in zip(DECAY_COLUMNS, sums[1:])}})
    return rows


def kernel_info() -> Dict[str, int]:
    """The kernel's resources (building the kernels if needed):
    registers, local-memory bytes and spill bytes a thread, static
    shared bytes a block, resident blocks and warps per SM."""
    from . import _build

    res = (ctypes.c_int * 5)()
    err = _build.load().vt_trace_info(ctypes.addressof(res))
    if err != 0:
        raise RuntimeError(f"trace kernel query failed: cudaError {err}")
    regs, local, shared, per_sm, threads = list(res)
    return {"registers": regs, "local_bytes": local,
            "spill_bytes": _spill_bytes(), "shared_bytes": shared,
            "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32}


def _spill_bytes() -> int:
    """The kernel's spill stores plus spill loads (bytes) from ptxas's
    report in the build log.  Its local memory (``local_bytes``) also
    holds the stack frame of the accurate cosf/sinf's large-argument
    path, which is not a spill."""
    from . import _build

    lines = _build.build_log().splitlines()
    for i, line in enumerate(lines):
        # the by-value entry's instance, trace_kernel<false, false>
        if ("Compiling entry function" in line
                and "trace_kernelILb0ELb0E" in line):
            for follow in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", follow)
                if m:
                    return int(m.group(1)) + int(m.group(2))
    raise RuntimeError("no ptxas report for trace_kernel in the build log")


def render_sample(
    tables: SceneTables,
    params,
    noise: torch.Tensor,
    frame,
    height: int,
    width: int,
    row0: int = 0,
    row_stride: int = 1,
) -> Dict[str, torch.Tensor]:
    """Trace one sample on the tables' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    args = (tables, params, noise, frame, height, width, row0, row_stride)
    kind = tables.device.type
    if kind == "cpu":
        return render_sample_plain(*args)
    if kind == "cuda":
        return render_sample_cuda(*args)
    raise ValueError(f"no trace implementation for device {tables.device}")

