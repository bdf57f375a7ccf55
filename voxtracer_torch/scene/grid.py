"""Dense voxel grid + occupancy mip pyramid — the TPU acceleration structure.

The reference traverses a pointer-chasing sparse octree on the GPU
(``shaders/voxels.comp:134-247``).  Pointer chasing is hostile to TPU
vector units, so the TPU-native equivalent is:

  * a dense int32 value grid over the scene's bounding box (0 = empty,
    negative = packed leaf value — same encoding, ``src/context.rs:734``),
  * a pyramid of boolean occupancy mips (level ``l`` cell = ``2**l`` base
    cells) enabling hierarchical DDA empty-space skipping with identical
    hit results to the octree traversal.

World mapping (must match the octree ABI): ``create_octree`` writes
``root_size = 2**depth`` and the traversal descends one level per
positive child until it finds a negative leaf (``voxels.comp:175-189``,
``src/context.rs:710-773``).  Working through both, an integer voxel at
position ``p`` occupies the world cube ``[p*0.5, p*0.5 + 0.5)`` — the
leaf cells of the octree sit one level *below* the integer lattice, so a
voxel is half a world unit across.  The grid stores that mapping as
``world = (index + origin) * CELL_SIZE``.

The port's copy of ``voxtracer/scene/grid.py``: ``device_tables()``
is the CUDA trace kernel's table ABI, bit-equal to the JAX package's in
both brick layouts (``tests/test_torch_hostlayer.py``).  Its distance
fields and node tables are the spans ``vt.scene.distance`` and
``vt.scene.nodes`` (``utils.timing.span``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..utils.timing import span
from .voxels import VoxelList, pack_leaves

CELL_SIZE = 0.5  # world size of one voxel

# Device palette capacity: leaf values are palettized so the TPU kernel
# can resolve hit colors with an in-VMEM (8, 128) table gather.  Scenes
# with more distinct leaf values (the random-colored procedural bowl)
# are quantized by hashing values into slots; colliding values share a
# color.  Quantization happens at build time, so the oracle, XLA and
# Pallas renderers all see the identical quantized scene.
PALETTE_CAPACITY = 1024

# Slots 0..RESERVED_SLOTS-1 of the 10-bit packed index are not palette
# entries but empty-space distances: an empty cell stores the capped
# chebyshev distance to the nearest occupied cell, so every fetched word
# answers "hit what?" OR "how far may I jump?" in one lookup — the TPU
# equivalent of the octree popping multiple levels at once
# (voxels.comp:191-221), with no separate skip level to fetch.
# Palette entries live at slots RESERVED_SLOTS..1023 (972 usable; the
# procedural quantizer emits at most 897 distinct leaves).
RESERVED_SLOTS = 32
DIST_CAP = RESERVED_SLOTS - 1

# L3 (4x4x4 fine cells) node-table distance cap; kept within uint8 so
# the native distance field stores it exactly.
L3_DIST_CAP = 255

# Content-addressed brick dedup: voxel scenes repeat 4x4x4 occupancy
# patterns heavily (menger's 6480 occupied nodes share 1041 distinct
# (mask, uniform-slot) pairs; every shipped asset <= 3139).  When the
# distinct count fits this many table entries, occupied meta words
# carry a 15-bit index into a tiny (3, rows, 128) unique-brick table
# (mask lo word / mask hi word / uniform palette slot) that the kernel
# serves with ONE static full sweep — no min-reduce, no adaptive
# rounds.  Beyond the cap the builder falls back to per-node (2, rows,
# 128) brick tables (the laddered cached serve).
BRICK_DEDUP_MAX = 4096


def _ceil_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class GridScene:
    """Device-friendly scene: dense values plus occupancy mips.

    Attributes:
      values: int32 [X, Y, Z]; 0 = empty, negative = packed leaf.
      origin: int32 [3] — voxel-lattice coordinate of grid index (0,0,0).
      shape:  padded grid dims (multiples of ``pad``).
      mips:   occupancy bools, mips[0] is full resolution, each following
              level halves every axis (shape padded up).
    """

    values: np.ndarray
    origin: np.ndarray
    mips: List[np.ndarray]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.values.shape

    def world_min(self) -> np.ndarray:
        return self.origin.astype(np.float32) * CELL_SIZE

    def world_max(self) -> np.ndarray:
        return (self.origin + np.array(self.values.shape)).astype(
            np.float32
        ) * CELL_SIZE

    @staticmethod
    def from_voxels(
        voxels: VoxelList, pad: int = 8, num_mips: int = 6
    ) -> "GridScene":
        if len(voxels) == 0:
            values = np.zeros((pad, pad, pad), dtype=np.int32)
            origin = np.zeros(3, dtype=np.int32)
        else:
            pos = voxels.pos.astype(np.int64)
            lo = pos.min(axis=0)
            hi = pos.max(axis=0)
            dims = [
                _ceil_multiple(int(h - l) + 1, pad) for l, h in zip(lo, hi)
            ]
            leaves = _quantize_leaves(pack_leaves(voxels.mrgb))
            origin = lo.astype(np.int32)
            # Later duplicates win, like repeated octree insertion
            # overwriting the same leaf slot.  The native (C++) fill is
            # used when built; the numpy path is bit-identical.
            from .. import native

            values = native.fill_grid(voxels.pos, leaves, origin, dims)
            if values is None:
                values = np.zeros(dims, dtype=np.int32)
                idx = pos - lo
                values[idx[:, 0], idx[:, 1], idx[:, 2]] = leaves

        mips = _build_mips(values != 0, num_mips)
        return GridScene(values=values, origin=origin, mips=mips)

    def device_tables(self) -> Dict[str, np.ndarray]:
        """Build the Pallas-kernel tables.

        Returns:
          packed_idx: (rows, 128) int32 — 3 consecutive-z 10-bit slots
            packed per word in pillar order, padded to whole 128-word
            rows.  Slot >= RESERVED_SLOTS: palette entry of an occupied
            cell.  Slot < RESERVED_SLOTS: the cell is empty and every
            cell within chebyshev radius slot-1 is empty too (capped
            distance field baked into the index).
          palette: (8, 128) int32 — slot -> packed leaf value
            (slots 0..RESERVED_SLOTS-1 stay 0).
          zw: number of packed words along z (= ceil(Z/3)).
        """
        from .. import native

        x_dim, y_dim, z_dim = self.values.shape
        zw = -(-z_dim // 3)

        with span("vt.scene.distance"):
            dist = native.block_dist(self.values, 0, DIST_CAP)
            if dist is None:
                dist = _chebyshev_distance(self.values != 0, cap=DIST_CAP)

        packed = native.pack_words(
            self.values, dist, PALETTE_CAPACITY, RESERVED_SLOTS
        )
        if packed is not None:
            flat_words, palette, zw = packed
        else:
            zp = zw * 3
            vals = self.values
            dpad = dist.astype(np.int64)
            if zp != z_dim:
                zpad = np.zeros((x_dim, y_dim, zp - z_dim), np.int32)
                vals = np.concatenate([vals, zpad], axis=2)
                dpad = np.concatenate([dpad, zpad.astype(np.int64)], axis=2)
            uniq = np.unique(vals)
            uniq = uniq[uniq != 0]
            assert (
                len(uniq) < PALETTE_CAPACITY - RESERVED_SLOTS
            ), "scene not palettized"
            palette = np.zeros(PALETTE_CAPACITY, np.int32)
            palette[RESERVED_SLOTS : RESERVED_SLOTS + len(uniq)] = uniq
            # occupied -> palette slot via searchsorted over sorted
            # uniques; empty -> its baked jump distance
            flat = vals.reshape(-1)
            slots = dpad.reshape(-1).copy()
            nz = flat != 0
            slots[nz] = (
                np.searchsorted(uniq, flat[nz]) + RESERVED_SLOTS
            )

            idx3 = slots.reshape(x_dim, y_dim, zw, 3)
            words = (
                (idx3 << np.array([0, 10, 20], np.int64)).sum(axis=3)
            ).astype(np.uint32)
            flat_words = words.reshape(-1).view(np.int32)
        # minimum 16 rows: the kernel's window serve slices 16 at a time
        # pillar layout: 4x4 (x, y) column blocks with contiguous z —
        # a ray neighborhood touches ~2x fewer 128-word rows than with
        # plain row-major (x, y) ordering, halving serve rounds in the
        # kernel.  dims are padded to multiples of 8, so 4 divides.
        assert x_dim % 4 == 0 and y_dim % 4 == 0
        flat_words = (
            flat_words.reshape(x_dim // 4, 4, y_dim // 4, 4, zw)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1)
        )
        n_rows = max(16, _ceil_multiple(len(flat_words), 128) // 128)
        padded = np.zeros(n_rows * 128, np.int32)
        padded[: len(flat_words)] = flat_words

        # Two node-level tables over 4x4x4 fine-cell blocks ("L3
        # cells") — together the TPU counterpart of an octree node
        # (voxels.comp:175-189), split by access pattern:
        #   meta_idx — the tiny march table the DDA serves on every
        #     L3 step (2 x 16-bit values per word): bit 15 set =
        #     occupied with bits 0-9 the block's uniform palette slot
        #     (0 if mixed, resolved from the fine table at the hit);
        #     bit 15 clear = capped chebyshev distance in L3 units
        #     (the octree's multi-level pop, voxels.comp:191-221).
        #   brick_idx — the block's full 64-bit fine-occupancy mask as
        #     two parallel (rows, 128) tables (lo/hi words, one shared
        #     address), fetched only on entering an occupied block,
        #     then marched entirely in registers.
        occ = self.values != 0
        sup_occ = _block_occ(occ)
        hx, hy, hz = sup_occ.shape
        px, py = _ceil_multiple(hx, 8), _ceil_multiple(hy, 8)
        if (px, py) != (hx, hy):
            grown = np.zeros((px, py, hz), bool)
            grown[:hx, :hy, :] = sup_occ
            sup_occ = grown
        l3_occ = _block_occ(sup_occ)
        with span("vt.scene.distance"):
            l3_d = native.block_dist(self.values, 2, L3_DIST_CAP)
            if l3_d is None:
                l3_d = _chebyshev_distance(l3_occ, cap=L3_DIST_CAP)
        if l3_d.shape != l3_occ.shape:  # native follows unpadded dims
            grown = np.zeros(l3_occ.shape, l3_d.dtype)
            grown[: l3_d.shape[0], : l3_d.shape[1], : l3_d.shape[2]] = l3_d
            l3_d = grown
        l3_dims = l3_occ.shape
        with span("vt.scene.nodes"):
            meta_idx, brick_idx = _pack_nodes(
                self.values, occ, l3_occ, l3_d, l3_dims, palette
            )

        return {
            "packed_idx": padded.reshape(n_rows, 128),
            "palette": palette.reshape(8, 128),
            "zw": zw,
            "meta_idx": meta_idx,
            "brick_idx": brick_idx,
            "l3_dims": l3_dims,
        }


def _block_occ(occ: np.ndarray) -> np.ndarray:
    """Child occupancy -> 2x-coarser block occupancy (z padded up)."""
    cx, cy, cz = occ.shape
    if cz % 2:
        occ = np.concatenate([occ, np.zeros((cx, cy, 1), bool)], axis=2)
    return occ.reshape(cx // 2, 2, cy // 2, 2, -1, 2).any(axis=(1, 3, 5))


def _pillar_pack(words: np.ndarray, group: int) -> np.ndarray:
    """(bx, by, bz, group) uint32 -> (rows, 128) int32 in 4x4 pillar
    order; ``group`` consecutive words per cell (never straddling a
    128-word row for group in {1, 2, 4})."""
    bx, by, bz = words.shape[:3]
    assert bx % 4 == 0 and by % 4 == 0
    flat = (
        words.reshape(bx // 4, 4, by // 4, 4, bz, group)
        .transpose(0, 2, 1, 3, 4, 5)
        .reshape(-1)
        .view(np.int32)
    )
    n_rows = max(16, _ceil_multiple(len(flat), 128) // 128)
    padded = np.zeros(n_rows * 128, np.int32)
    padded[: len(flat)] = flat
    return padded.reshape(n_rows, 128)


def _pack_nodes(
    values: np.ndarray,
    occ: np.ndarray,
    l3_occ: np.ndarray,
    l3_d: np.ndarray,
    l3_dims,
    palette: np.ndarray,
):
    """Build (meta_idx, brick_idx) — see ``device_tables``.

    meta: one 16-bit value per L3 cell, two per word at address
    ``colq * ceil(QZ/2) + qz//2`` (halfword ``qz & 1``).  brick: the
    64-bit fine mask split over two (rows, 128) tables — stacked as
    ``(2, rows, 128)`` — both indexed by the node linear address
    ``colq * QZ + qz`` (bit ``(x&3)*16 + (y&3)*4 + (z&3)``; table 0
    holds bits 0-31).
    """
    qx_d, qy_d, qz_d = (int(d) for d in l3_dims)
    fx, fy, fz = qx_d * 4, qy_d * 4, qz_d * 4
    occ_p = occ
    vals_p = values
    if occ.shape != (fx, fy, fz):
        occ_p = np.zeros((fx, fy, fz), bool)
        occ_p[: occ.shape[0], : occ.shape[1], : occ.shape[2]] = occ
        vals_p = np.zeros((fx, fy, fz), np.int32)
        vals_p[
            : values.shape[0], : values.shape[1], : values.shape[2]
        ] = values
    bits = (
        occ_p.reshape(qx_d, 4, qy_d, 4, qz_d, 4)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(qx_d, qy_d, qz_d, 64)
        .astype(np.int64)
    )
    weights = np.int64(1) << np.arange(32, dtype=np.int64)
    lo = (bits[..., :32] * weights).sum(axis=-1)
    hi = (bits[..., 32:] * weights).sum(axis=-1)

    # uniform palette slot per block (0 when mixed / empty)
    v64 = vals_p.astype(np.int64)
    vb = (
        v64.reshape(qx_d, 4, qy_d, 4, qz_d, 4)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(qx_d, qy_d, qz_d, 64)
    )
    occ_b = bits == 1
    big = np.int64(1) << 62
    vmin = np.where(occ_b, vb, big).min(axis=-1)
    vmax = np.where(occ_b, vb, -big).max(axis=-1)
    uniform = l3_occ & (vmin == vmax)
    # value -> palette slot (leaf values are distinct in the palette)
    pal = palette.reshape(-1).astype(np.int64)
    order = np.argsort(pal, kind="stable")
    pal_sorted = pal[order]
    uval = np.where(uniform, vmin, np.int64(0))
    pos = np.searchsorted(pal_sorted, uval)
    pos = np.clip(pos, 0, len(pal) - 1)
    slot = np.where(
        uniform & (pal_sorted[pos] == uval), order[pos], 0
    ).astype(np.int64)

    # content-addressed dedup over (64-bit mask, uniform slot) pairs —
    # see BRICK_DEDUP_MAX.  Empty nodes map to entry (0, 0); they never
    # consult the brick table.
    # combine in uint64: with mask bit 63 set, (lo | hi<<32) in int64
    # would rely on silent two's-complement wraparound (bijective but
    # fragile under future NumPy overflow strictness)
    key64 = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    keys = np.stack(
        [key64.reshape(-1), slot.reshape(-1).astype(np.uint64)], axis=1
    )
    uniq_keys, inv = np.unique(keys, axis=0, return_inverse=True)
    if len(uniq_keys) <= BRICK_DEDUP_MAX:
        bidx = inv.reshape(qx_d, qy_d, qz_d).astype(np.int64)
        meta16 = np.where(
            l3_occ, np.int64(0x8000) | bidx, l3_d.astype(np.int64)
        )
        rows = max(8, -(-len(uniq_keys) // 128))
        tab = np.zeros((3, rows * 128), np.uint32)
        umask = uniq_keys[:, 0]
        m32 = np.uint64(0xFFFFFFFF)
        tab[0, : len(uniq_keys)] = umask & m32
        tab[1, : len(uniq_keys)] = (umask >> np.uint64(32)) & m32
        tab[2, : len(uniq_keys)] = uniq_keys[:, 1]
        brick_idx = (
            tab.view(np.int32).reshape(3, rows, 128)
        )
    else:
        # per-node fallback: the mask's two 32-bit halves as two
        # parallel tables sharing one address (node linear index), the
        # uniform slot in the meta word
        brick_idx = np.stack(
            [
                _pillar_pack(lo[..., None].astype(np.uint32), 1),
                _pillar_pack(hi[..., None].astype(np.uint32), 1),
            ],
            axis=0,
        )
        meta16 = np.where(
            l3_occ, np.int64(0x8000) | slot, l3_d.astype(np.int64)
        )
    if qz_d % 2:
        meta16 = np.concatenate(
            [meta16, np.zeros((qx_d, qy_d, 1), np.int64)], axis=2
        )
    m2 = meta16.reshape(qx_d, qy_d, -1, 2)
    meta_words = (m2[..., 0] | (m2[..., 1] << 16)).astype(np.uint32)
    meta_idx = _pillar_pack(meta_words[..., None], 1)
    return meta_idx, brick_idx


def _quantize_leaves(leaves: np.ndarray) -> np.ndarray:
    """Map leaf values into at most PALETTE_CAPACITY - 1 distinct values.

    Lossless whenever the scene already has < PALETTE_CAPACITY distinct
    leaves (every .vox scene: <= 512).  Beyond that (the random-colored
    procedural bowl), colors snap to the centers of an 8x8x7 RGB cube
    per material byte — a bounded, unbiased quantization (a hash-bucket
    scheme would bias each bucket toward its representative's hue).
    """
    uniq = np.unique(leaves)
    if len(uniq) < PALETTE_CAPACITY - RESERVED_SLOTS:
        return leaves
    v = leaves.astype(np.int64)
    mat = (v >> 24) & 0x7F
    r = (v >> 16) & 0xFF
    g = (v >> 8) & 0xFF
    b = v & 0xFF
    # 8 x 8 x 7 level centers per material (<= 2 material bytes in
    # practice: diffuse / emissive), 896 < PALETTE_CAPACITY - 1
    rq = (r >> 5) * 32 + 16
    gq = (g >> 5) * 32 + 16
    bq = (2 * np.minimum(b * 7 // 256, 6) + 1) * 256 // 14
    out = (1 << 31) | (mat << 24) | (rq << 16) | (gq << 8) | bq
    return (out - (1 << 32)).astype(np.int32)


def _chebyshev_distance(occ: np.ndarray, cap: int) -> np.ndarray:
    """Chebyshev (max-norm) distance to the nearest occupied block,
    capped at ``cap``; 0 where occupied.

    Chamfer iteration with a separable 3-wide min filter: ``k`` rounds
    make every distance <= k exact, and clamping the rest to ``cap`` is
    conservative (a shorter jump is always safe).
    """
    big = np.uint16(cap + 1)
    d = np.where(occ, np.uint16(0), big)
    for _ in range(cap):
        m = d
        for axis in range(3):
            lo = np.roll(m, 1, axis=axis)
            hi = np.roll(m, -1, axis=axis)
            # roll wraps; the wrapped slice is re-set to the edge value
            # (out-of-grid is "empty at infinity", never a tighter min)
            idx_lo = [slice(None)] * 3
            idx_lo[axis] = slice(0, 1)
            lo[tuple(idx_lo)] = big
            idx_hi = [slice(None)] * 3
            idx_hi[axis] = slice(-1, None)
            hi[tuple(idx_hi)] = big
            m = np.minimum(m, np.minimum(lo, hi))
        nd = np.minimum(d, m + 1)
        if np.array_equal(nd, d):
            break
        d = nd
    return np.minimum(d, np.uint16(cap)).astype(np.uint8)


def _build_mips(occ0: np.ndarray, num_mips: int) -> List[np.ndarray]:
    mips = [occ0]
    cur = occ0
    for _ in range(1, num_mips):
        if max(cur.shape) <= 1:
            break
        dims = [_ceil_multiple(s, 2) for s in cur.shape]
        if dims != list(cur.shape):
            padded = np.zeros(dims, dtype=bool)
            padded[: cur.shape[0], : cur.shape[1], : cur.shape[2]] = cur
            cur = padded
        cur = (
            cur.reshape(
                dims[0] // 2, 2, dims[1] // 2, 2, dims[2] // 2, 2
            ).any(axis=(1, 3, 5))
        )
        mips.append(cur)
    return mips
