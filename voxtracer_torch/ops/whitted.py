"""Legacy sorted-octant Whitted raytracer (reference ``shaders/basic.frag``).

Counterpart of :mod:`voxtracer.ops.whitted`, in plain torch on any
device.  The reference ships a second, older renderer: a fragment-shader
Whitted raytracer that walks the flat pointer octree
(``scene/octree.py``) front-to-back by sorting each node's octants along
the ray (``basic.frag:70-132``), shades the first hit with one
point-light shadow ray (``basic.frag:242-271``), and is dead code in the
reference — no pipeline binds it.  It indexes children as
``nodes[node + octant]`` (``basic.frag:191``) while the octree builder
stores node *indices* (``src/context.rs:711-716``) and the live shader
reads ``nodes[8*node + octant]`` (``shaders/voxels.comp:175``); the JAX
package implements the algorithm against the real ABI so that it
renders, and that deliberate deviation is the only one.  This port
keeps it.

The JAX package runs the per-pixel recursion as one ``lax.while_loop``
over an explicit ``MAX_DEPTH``-frame stack, ``vmap``-ed over the pixels
(no Pallas kernel).  Here the rays are a batch dimension: every step
advances all live rays at once, with per-ray stack tensors and masks,
and the rays that finished (stack empty, a hit, or the ``MAX_ITERS``
fuse spent) leave the batch, so a step costs what the live rays need.
Each ray's arithmetic is the reference's, in its order; the ray
directions' norms use :func:`voxtracer_torch.ops.trace.sqrt_f32`.

World geometry note (from the reference): integer voxel ``p`` occupies
the world cell ``[p/2, (p+1)/2)`` — the legacy renderer draws the scene
at half scale.
"""

from __future__ import annotations

import numpy as np
import torch

from .trace import sqrt_f32

MAX_DEPTH = 10  # basic.frag:3
# Safety fuse absent in the fragment shader: a full traversal touches
# each stacked node at most count + 1 <= 5 times.
MAX_ITERS = 4096
# rays a batch: bounds the per-ray stack tensors (about 0.5 KB a ray)
CHUNK = 1 << 18

_F = torch.float32
_I = torch.int64


def _ray_cube(origin, inv_dir, center, half_size):
    """``ray_cube_intersection`` (basic.frag:24-41): slab test with the
    entry/exit planes picked by the sign of ``inv_dir``.  (N, 3) rays,
    center (N, 3) or (3,), half_size (N,) or a 0-dim tensor."""
    signum = torch.sign(inv_dir)
    hs = half_size[..., None] if half_size.dim() else half_size
    entries = (center - hs * signum - origin) * inv_dir
    exits = (center + hs * signum - origin) * inv_dir
    entry = entries.amax(-1)
    exit_ = exits.amin(-1)
    return (exit_ >= 0) & (entry < exit_), entry, exit_


def _octant_center(center, size, octant):
    """basic.frag:43-46 — child center offset by ±size/4 per axis bit."""
    bits = torch.stack([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1],
                       -1).to(_F)
    quarter = torch.tensor(0.25, dtype=_F, device=size.device) * size
    return center + quarter[:, None] * torch.sign(bits - 0.5)


def _put(a, index, value, mask):
    """``a[r, index[r]] = value[r]`` where ``mask[r]``."""
    put = a.scatter(1, index[:, None], value[:, None])
    return torch.where(mask[:, None], put, a)


def _octant_intersections(origin, inv_dir, center, size, entry, exit_):
    """``octant_intersections`` (basic.frag:70-132): the octants each ray
    crosses inside its node, front to back, with their entry times.

    Returns ``(octs (N, 5) i64, ents (N, 5) f32, count (N,) i64)``; slot
    ``count`` of ``ents`` holds the node exit time, like the GLSL's
    trailing ``entries[count] = exit``.
    """
    n = origin.shape[0]
    dev = origin.device
    delta = center - origin
    pe = delta * inv_dir  # mid-plane crossing time per axis

    # Sort the three axes by crossing time with the GLSL's comparison
    # ladder (basic.frag:78-92), ties and NaN included (NaN compares
    # false, leaving the identity order).
    def take(o):
        return pe.gather(1, o[:, None])[:, 0]

    c1 = pe[:, 1] < pe[:, 0]
    o0 = torch.where(c1, 1, 0).to(_I)
    o1 = torch.where(c1, 0, 1).to(_I)
    o2 = torch.full((n,), 2, dtype=_I, device=dev)
    c2 = pe[:, 2] < take(o1)
    c3 = pe[:, 2] < take(o0)
    o2_n = torch.where(c2, o1, o2)
    o1_n = torch.where(c2, torch.where(c3, o0, o2), o1)
    o0_n = torch.where(c2 & c3, o2, o0)
    order = torch.stack([o0_n, o1_n, o2_n], -1)
    sorted_pe = pe.gather(1, order)

    # Starting octant: which side of each mid-plane the ray enters on
    # (basic.frag:96-99 — the !(delta>0) arm resolves the on-plane case
    # by travel direction).
    side = (delta < 0) | (~(delta > 0) & (inv_dir < 0))
    octant = (side[:, 0].to(_I) * 4 + side[:, 1].to(_I) * 2
              + side[:, 2].to(_I))

    octs = torch.zeros((n, 5), dtype=_I, device=dev)
    ents = torch.zeros((n, 5), dtype=_F, device=dev)
    count = torch.zeros((n,), dtype=_I, device=dev)
    prev_time = entry

    for i in range(3):  # fixed trip count (basic.frag:104-120)
        e_i = sorted_pe[:, i]
        skip = (e_i < 0) | (e_i >= exit_)  # crossing outside the node
        store = ~skip & (e_i >= entry)
        octs = _put(octs, count, octant, store)
        ents = _put(ents, count, prev_time, store)
        count = count + store.to(_I)
        prev_time = torch.where(store, e_i, prev_time)
        # continue skips the octant flip too (basic.frag:106,119)
        flip = torch.bitwise_right_shift(
            torch.full_like(order[:, i], 4), order[:, i])
        octant = torch.where(skip, octant, octant ^ flip)

    # The octant the ray exits through always lands (basic.frag:122-131).
    every = torch.ones((n,), dtype=torch.bool, device=dev)
    octs = _put(octs, count, octant, every)
    ents = _put(ents, count, prev_time, every)
    count = count + 1
    ents = _put(ents, count, exit_, every)
    return octs, ents, count


def _pick(a, index):
    """``a[r, index[r]]`` for a (N, K) or (N, K, C) tensor."""
    if a.dim() == 2:
        return a.gather(1, index[:, None])[:, 0]
    idx = index[:, None, None].expand(-1, 1, a.shape[2])
    return a.gather(1, idx)[:, 0]


def _pick2(a, c, i):
    """``a[r, c[r], i[r]]`` for a (N, K, L) tensor."""
    rows = a.gather(1, c[:, None, None].expand(-1, 1, a.shape[2]))[:, 0]
    return rows.gather(1, i[:, None])[:, 0]


def cast_ray(nodes, root_center, root_size, origin, direction):
    """``cast_ray`` (basic.frag:142-240) for a batch of rays: (N, 3)
    origins and unit directions.

    Returns ``(hit (N,) bool, time (N,) f32, color (N, 3) f32, normal
    (N, 3) f32)``.  ``nodes`` is the flat node buffer (header stripped)
    widened to int64, the stack's index type; children are addressed
    ``nodes[8*node + octant]`` per the builder's ABI.
    """
    n = origin.shape[0]
    dev = origin.device
    one = torch.tensor(1.0, dtype=_F, device=dev)
    half = torch.tensor(0.5, dtype=_F, device=dev)
    inv_dir = one / direction
    intersect, root_entry, root_exit = _ray_cube(
        origin, inv_dir, root_center, half * root_size)
    r_octs, r_ents, r_count = _octant_intersections(
        origin, inv_dir, root_center.expand(n, 3),
        root_size.expand(n), root_entry, root_exit)

    # Explicit stack of MAX_DEPTH frames per ray (basic.frag:134-146).
    d = MAX_DEPTH
    st_node = torch.zeros((n, d), dtype=_I, device=dev)
    st_stage = torch.zeros((n, d), dtype=_I, device=dev)
    st_center = torch.zeros((n, d, 3), dtype=_F, device=dev)
    st_center[:, 0] = root_center
    st_size = torch.zeros((n, d), dtype=_F, device=dev)
    st_size[:, 0] = root_size
    st_octs = torch.zeros((n, d, 5), dtype=_I, device=dev)
    st_octs[:, 0] = r_octs
    st_ents = torch.zeros((n, d, 5), dtype=_F, device=dev)
    st_ents[:, 0] = r_ents
    st_count = torch.zeros((n, d), dtype=_I, device=dev)
    st_count[:, 0] = r_count
    sp = intersect.to(_I)

    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    time = torch.zeros((n,), dtype=_F, device=dev)
    value = torch.zeros((n,), dtype=torch.int32, device=dev)
    nplane = torch.zeros((n,), dtype=_I, device=dev)

    # the live rays, by index; a ray leaves when its stack is empty, it
    # hit, or the fuse is spent
    ids = torch.arange(n, device=dev)
    live = (st_node, st_stage, st_center, st_size, st_octs, st_ents,
            st_count, sp, origin, direction, inv_dir)
    alive = sp > 0
    ids = ids[alive]
    live = tuple(t[alive] for t in live)
    for _ in range(MAX_ITERS):
        if ids.numel() == 0:
            break
        (st_node, st_stage, st_center, st_size, st_octs, st_ents, st_count,
         sp, o, dr, inv) = live
        c = sp - 1
        i = _pick(st_stage, c)
        rows = torch.arange(ids.numel(), device=dev)
        st_stage[rows, c] = i + 1

        pop = i >= _pick(st_count, c)  # node exhausted (basic.frag:181-185)
        i = i.clamp(max=4)  # a popped frame's slot is never used
        node = _pick(st_node, c)
        octant = _pick2(st_octs, c, i)
        val = nodes[8 * node + octant]

        is_leaf = ~pop & (val < 0)
        is_child = ~pop & (val > 0)

        size = _pick(st_size, c)
        child_center = _octant_center(_pick(st_center, c), size, octant)

        # Leaf: record hit time + face normal plane (basic.frag:194-204).
        t_hit = _pick2(st_ents, c, i)
        point = o + dr * t_hit[:, None]
        dists = (point - child_center).abs()
        max_d = dists.amax(-1)
        npl = torch.where(dists[:, 0] == max_d, 0,
                          torch.where(dists[:, 1] == max_d, 1, 2)).to(_I)

        # Child: intersect its octants and push (basic.frag:209-224).
        child_size = half * size
        c_octs, c_ents, c_count = _octant_intersections(
            o, inv, child_center, child_size, t_hit,
            _pick2(st_ents, c, (i + 1).clamp(max=4)))
        push = is_child & (sp < d)
        r = push.nonzero()[:, 0]
        top = sp[r]
        st_node[r, top] = val[r]
        st_stage[r, top] = 0
        st_center[r, top] = child_center[r]
        st_size[r, top] = child_size[r]
        st_octs[r, top] = c_octs[r]
        st_ents[r, top] = c_ents[r]
        st_count[r, top] = c_count[r]
        sp = sp + push.to(_I) - pop.to(_I)

        # a leaf ends its ray: record it where the ray lives
        where = ids[is_leaf]
        hit[where] = True
        time[where] = t_hit[is_leaf]
        value[where] = val[is_leaf].to(torch.int32)
        nplane[where] = npl[is_leaf]

        stay = (sp > 0) & ~is_leaf
        ids = ids[stay]
        live = tuple(t[stay] for t in (
            st_node, st_stage, st_center, st_size, st_octs, st_ents,
            st_count, sp, o, dr, inv))

    # Unpack the leaf color (basic.frag:231-234); arithmetic >> on the
    # negative i32 then mask, as the GLSL.
    color = torch.stack([(value >> 16) & 0xFF, (value >> 8) & 0xFF,
                         value & 0xFF], -1).to(_F) / torch.tensor(
                             255.0, dtype=_F, device=dev)
    axis_hot = torch.nn.functional.one_hot(nplane, 3).to(_F)
    along = direction * axis_hot
    normal = -torch.sign(along[:, 0] + along[:, 1] + along[:, 2])[:, None] \
        * axis_hot
    return hit, time, color, normal


def _norm(v):
    """``jnp.linalg.norm`` of (N, 3) rows: sqrt of ((x*x + y*y) + z*z)."""
    return sqrt_f32(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def _shade(nodes, root_center, root_size, origin, direction, light_pos,
           light_brightness):
    """``main`` (basic.frag:242-271): first hit + one point-light shadow
    ray; a miss shows ``abs(dir)``."""
    direction = direction / _norm(direction)[:, None]
    hit, time, color, normal = cast_ray(
        nodes, root_center, root_size, origin, direction)

    dev = direction.device
    out = direction.abs()
    if not bool(hit.any()):
        return out
    # the shadow ray of the rays that hit (the others show the sky)
    h = hit.nonzero()[:, 0]
    d, t, col, nrm = direction[h], time[h], color[h], normal[h]

    def const(v):
        return torch.tensor(v, dtype=_F, device=dev)

    hit_point = origin[h] + d * (const(0.99999) * t)[:, None]
    to_hit = hit_point - light_pos
    light_distance = _norm(to_hit)
    light_dir = to_hit / light_distance[:, None]
    obstructed, shadow_time, _, _ = cast_ray(
        nodes, root_center, root_size, hit_point, -light_dir)
    shadow = obstructed & (shadow_time <= light_distance)

    lit = -light_dir * nrm
    diffuse = (
        const(0.8) * light_brightness
        * torch.maximum(lit[:, 0] + lit[:, 1] + lit[:, 2], const(0.0))
        / (light_distance * light_distance)
    )
    brightness = const(0.2) + torch.where(shadow, const(0.3) * diffuse,
                                          diffuse)
    out[h] = col * brightness[:, None]
    return out


def render_whitted(octree, origin, right, up, forward, light_pos,
                   light_brightness, *, width, height, chunk=CHUNK):
    """Render the legacy Whitted view: one ray per pixel over the flat
    octree blob (header + nodes, as built by
    :func:`voxtracer_torch.scene.octree.build_octree`), on the device of
    ``octree``.

    ``right/up/forward`` is the pixel-space basis from
    ``Camera.axis_scaled`` — ``ray(px, py) = px*right - py*up + forward``,
    the same convention as the live renderer.  Every vector is a float32
    tensor on that device, ``light_brightness`` a 0-dim one.  Returns an
    (H, W, 3) f32 image.  Rays go in batches of ``chunk``, which bounds
    the stack tensors' memory."""
    header = octree[:5].view(_F)
    root_center = header[:3]
    root_size = header[3]
    nodes = octree[5:].to(_I)
    dev = octree.device

    px = torch.arange(width, dtype=_F, device=dev) + 0.5
    py = torch.arange(height, dtype=_F, device=dev) + 0.5
    dirs = (
        px[None, :, None] * right[None, None, :]
        - py[:, None, None] * up[None, None, :]
        + forward[None, None, :]
    ).reshape(-1, 3)
    blocks = []
    for start in range(0, dirs.shape[0], chunk):
        d = dirs[start:start + chunk]
        blocks.append(_shade(nodes, root_center, root_size,
                             origin.expand(d.shape[0], 3), d, light_pos,
                             light_brightness))
    return torch.cat(blocks).reshape(height, width, 3)


def render_scene(voxels, camera, width, height,
                 light_pos=(0.4, -0.4, 0.02), light_brightness=0.05,
                 device="cuda") -> torch.Tensor:
    """Voxel list -> legacy Whitted frame on ``device``.

    Light defaults are the reference's legacy-era bindings
    (``src/context.rs:944-947``).  Note the half-scale world: voxel ``p``
    occupies ``[p/2, (p+1)/2)``, so cameras framed for the live renderer
    sit twice as far out here.
    """
    from ..scene.octree import build_octree

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")

    def f32(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(dev)

    right, up, forward = camera.axis_scaled(width, height)
    return render_whitted(
        torch.from_numpy(build_octree(voxels)).to(dev),
        f32(camera.position), f32(right), f32(up), f32(forward),
        f32(light_pos), f32(light_brightness),
        width=width, height=height,
    )
