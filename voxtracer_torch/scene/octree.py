"""Flat int32 pointer-octree builder (reference storage-ABI parity).

The port's copy of ``voxtracer/scene/octree.py`` (numpy only; the port
imports nothing of the JAX package), held bit-equal to it by
``tests/test_torch_whitted.py``.  The reference uploads scenes to the GPU
as a flat ``i32`` buffer (``src/context.rs:710-796``): a 5-word header
(root center xyz, root size, child size — all f32 bit-cast to i32)
followed by nodes of 8 consecutive i32 slots.  Slot values: ``0`` empty,
``> 0`` child node index, ``< 0`` packed leaf.  Octant index is
``4*(x >= cx) + 2*(y >= cy) + (z >= cz)`` (``src/context.rs:726-729``).

The path tracer traverses the dense grid; the legacy Whitted renderer
(``ops/whitted.py``) walks this octree.  It is built breadth-first with
vectorized numpy passes over sorted octant paths instead of per-voxel
pointer insertion — node numbering therefore differs from the
reference's insertion-order allocation, which the ABI permits
(consumers follow indices).
"""
from __future__ import annotations

import numpy as np

from .voxels import VoxelList, pack_leaves


def octree_depth(pos: np.ndarray) -> int:
    """Tree depth fitting all voxel coords, as ``voxel_depth``
    (``src/context.rs:813-834``): smallest d with every coordinate c
    satisfying ``-2**d <= c`` and ``c < 2**d``."""
    if len(pos) == 0:
        return 0

    def ceil_log2(x: int) -> int:
        return max(0, int(x) - 1).bit_length()

    lo = int(pos.min())
    hi = int(pos.max())
    min_depth = ceil_log2(max(1, abs(lo)))
    max_depth = ceil_log2(abs(hi) + 1)
    return max(min_depth, max_depth)


def _octant_paths(pos: np.ndarray, depth: int) -> np.ndarray:
    """Per-voxel octant index at every level, root first -> (N, depth+1).

    Level k partitions each axis at centers; following the reference's
    integer insertion arithmetic, the octant bits at level k are simply
    the bits of ``pos + 2**depth`` read from the top: offsetting by the
    root half-extent turns signed coords into unsigned ones whose binary
    digits are exactly the successive octant choices.
    """
    n = len(pos)
    unsigned = pos.astype(np.int64) + (1 << depth)
    assert unsigned.min() >= 0 and unsigned.max() < (1 << (depth + 1))
    out = np.empty((n, depth + 1), dtype=np.int8)
    for level in range(depth + 1):
        shift = depth - level
        bits = (unsigned >> shift) & 1
        out[:, level] = bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]
    return out


def build_octree(voxels: VoxelList) -> np.ndarray:
    """Voxel list -> flat i32 octree buffer with the 5-word header."""
    depth = octree_depth(voxels.pos)
    root_size = np.float32(2 ** depth)
    header = np.array(
        [0.0, 0.0, 0.0, root_size, 1.0], dtype=np.float32
    ).view(np.int32)

    if len(voxels) == 0:
        return np.concatenate([header, np.zeros(8, np.int32)])

    paths = _octant_paths(voxels.pos, depth)
    leaves = pack_leaves(voxels.mrgb)

    # Deduplicate voxels at identical positions: the last write wins, as
    # with repeated insertion into the same leaf slot.
    keys = np.zeros(len(voxels), dtype=np.int64)
    for level in range(depth + 1):
        keys = (keys << 3) | paths[:, level]
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    keep = np.ones(len(keys_sorted), dtype=bool)
    keep[:-1] = keys_sorted[:-1] != keys_sorted[1:]
    uniq_idx = order[keep]
    keys = keys[uniq_idx]
    leaves = leaves[uniq_idx]
    paths = paths[uniq_idx]

    # Breadth-first construction: level k holds one node per distinct
    # octant prefix of length k.  Vectorized np.unique on path prefixes
    # yields both the node ids and each voxel's node at that level.
    n_voxels = len(keys)
    prefix = np.zeros(n_voxels, dtype=np.int64)
    # node id of each voxel's containing node per level
    node_of_voxel = np.zeros(n_voxels, dtype=np.int64)
    level_node_count = [1]
    level_first_prefixes = [np.zeros(1, dtype=np.int64)]
    for level in range(depth):
        prefix = (prefix << 3) | paths[:, level]
        uniq, inv = np.unique(prefix, return_inverse=True)
        level_node_count.append(len(uniq))
        level_first_prefixes.append(uniq)
        node_of_voxel = inv

    total_nodes = sum(level_node_count)
    nodes = np.zeros(total_nodes * 8, dtype=np.int32)

    # Child pointers: a node at level k+1 with prefix P has parent
    # prefix P >> 3 and octant P & 7.
    base = np.cumsum([0] + level_node_count[:-1])
    for level in range(1, depth + 1):
        child_prefixes = level_first_prefixes[level]
        parent_prefixes = child_prefixes >> 3
        octants = (child_prefixes & 7).astype(np.int64)
        parent_ids = (
            np.searchsorted(level_first_prefixes[level - 1], parent_prefixes)
            + base[level - 1]
        )
        child_ids = np.arange(len(child_prefixes)) + base[level]
        nodes[parent_ids * 8 + octants] = child_ids.astype(np.int32)

    # Leaves live in the deepest nodes at the final octant.
    leaf_nodes = node_of_voxel + base[depth]
    nodes[leaf_nodes * 8 + paths[:, depth]] = leaves

    return np.concatenate([header, nodes])


def resolve_octree(octree: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Follow the flat octree down to the leaf slots for integer voxel
    positions ``pos`` (N,3) -> int32 values (0 if empty).  Used by tests
    to assert builder correctness."""
    header = octree[:5].view(np.float32)
    depth = int(np.round(np.log2(header[3])))
    nodes = octree[5:]
    unsigned = pos.astype(np.int64) + (1 << depth)
    current = np.zeros(len(pos), dtype=np.int64)
    alive = np.ones(len(pos), dtype=bool)
    value = np.zeros(len(pos), dtype=np.int32)
    for level in range(depth + 1):
        shift = depth - level
        bits = (unsigned >> shift) & 1
        octant = bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]
        slot = nodes[current * 8 + octant]
        if level == depth:
            value[alive] = slot[alive]
        else:
            leaf_now = slot < 0
            value[alive & leaf_now] = slot[alive & leaf_now]
            alive &= slot > 0
            current = np.where(alive, slot, 0).astype(np.int64)
    return value
