"""The trace kernel's scene tables built with torch ops on a device.

The same four tables as :meth:`GridScene.device_tables` (``grid.py``),
bit for bit in both brick layouts, made from one upload of the value
grid on the device that will hold them, so nothing is built on the host
and nothing is copied back.  ``engine/scene.py`` ``SceneTables`` takes
this path on a CUDA device; on the CPU it keeps the host build, which
the tests hold against the JAX package and hold this module against
(``tests/test_torch_scene_device_build.py``, on CPU tensors).

How each piece is made:

* distance fields: the capped Chebyshev distance to the nearest
  occupied cell is the number of 3x3x3 dilations (one cell along each
  axis in turn, out-of-grid never occupied) it takes to reach a cell, up
  to the cap;
* palette and packed words: the sorted distinct non-zero values at
  slots ``RESERVED_SLOTS..``, each occupied cell's slot by
  ``searchsorted``, empty cells their jump distance, three 10-bit slots
  a word in 4x4 pillar order;
* node tables: the occupancy seen as (nodes, 64) bits summed into two
  32-bit halves; a block's uniform slot from the least and the largest
  slot of its occupied cells; the dedup layout's brick order is
  ``np.unique``'s over (uint64 mask, slot), kept by ranking the masks
  first and the (rank, slot) pairs second.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import span
from . import grid
from .grid import (
    DIST_CAP,
    L3_DIST_CAP,
    PALETTE_CAPACITY,
    RESERVED_SLOTS,
    _ceil_multiple,
)


def _dilate(occ: torch.Tensor) -> torch.Tensor:
    """``occ`` grown by one cell along every axis in turn: a 3x3x3
    dilation, with nothing beyond the grid's faces."""
    for dim in range(3):
        n = occ.shape[dim]
        grown = occ.clone()
        grown.narrow(dim, 1, n - 1).logical_or_(occ.narrow(dim, 0, n - 1))
        grown.narrow(dim, 0, n - 1).logical_or_(occ.narrow(dim, 1, n - 1))
        occ = grown
    return occ


def _capped_distance(occ: torch.Tensor, cap: int) -> torch.Tensor:
    """uint8 Chebyshev distance to the nearest True cell of ``occ``,
    capped at ``cap``; 0 where ``occ``.  A cell at distance d is reached
    in the dilation rounds d..cap-1 of 0..cap-1, so cap less that count
    is min(d, cap), with no test a round (the rounds cost less than the
    host's wait for a test)."""
    reached = occ
    count = occ.to(torch.uint8)
    for _ in range(cap - 1):
        reached = _dilate(reached)
        count += reached
    return cap - count


def _int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return ((words ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _pillar_rows(words: torch.Tensor) -> torch.Tensor:
    """(bx, by, bz) int32 -> (rows, 128) int32 in 4x4 pillar order,
    zero-padded to whole rows, at least 16 (``grid._pillar_pack`` with a
    group of one)."""
    bx, by, bz = words.shape
    flat = (words.reshape(bx // 4, 4, by // 4, 4, bz)
            .permute(0, 2, 1, 3, 4).reshape(-1))
    n_rows = max(16, _ceil_multiple(flat.numel(), 128) // 128)
    out = torch.zeros(n_rows * 128, dtype=torch.int32, device=words.device)
    out[: flat.numel()] = flat
    return out.view(n_rows, 128)


def _mask_half(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) bool -> int64 sum of bit i << i, in [0, 2^32)."""
    words = bits.to(torch.int64)
    words <<= torch.arange(32, dtype=torch.int64, device=bits.device)
    return words.sum(dim=-1)


def device_tables(values: np.ndarray, device) -> Dict[str, object]:
    """``GridScene.device_tables()`` of the grid ``values`` (int32, x and
    y multiples of 4), built on ``device``: the four tables as int32
    tensors there, ``zw`` and ``l3_dims`` as ints.  Opens the spans
    ``vt.scene.upload`` (the value grid's one copy), ``vt.scene.distance``
    (twice) and ``vt.scene.nodes``.

    Each torch kernel's first launch in a process loads its module on a
    card (tens of ms a kernel family), so the build keeps to few
    families: the palette's (under 1024) and the dedup table's (at most
    ``BRICK_DEDUP_MAX``) entries are made on the host from their
    distinct values."""
    device = torch.device(device)
    x_dim, y_dim, z_dim = (int(d) for d in values.shape)
    if x_dim % 4 or y_dim % 4:
        raise ValueError(f"grid x and y must be multiples of 4: "
                         f"{values.shape}")
    zw = -(-z_dim // 3)

    with span("vt.scene.upload"):
        vals = torch.from_numpy(np.ascontiguousarray(values, np.int32))
        vals = vals.to(device)
    occ = vals.to(torch.bool)
    with span("vt.scene.distance"):
        dist = _capped_distance(occ, DIST_CAP)

    # palette: the sorted distinct leaves at slots RESERVED_SLOTS..
    distinct = torch.unique(vals).cpu().numpy()
    leaves = distinct[distinct != 0]
    if len(leaves) >= PALETTE_CAPACITY - RESERVED_SLOTS:
        raise AssertionError("scene not palettized")
    palette = np.zeros(PALETTE_CAPACITY, np.int32)
    palette[RESERVED_SLOTS: RESERVED_SLOTS + len(leaves)] = leaves
    # a cell's 10-bit code: its palette slot if occupied, else its jump
    # distance (1..DIST_CAP, so occupied <=> code >= RESERVED_SLOTS)
    cell_slot = torch.searchsorted(torch.from_numpy(leaves).to(device), vals,
                                   out_int32=True)
    del vals
    cell_slot += RESERVED_SLOTS
    code = torch.where(occ, cell_slot.to(torch.int16), dist.to(torch.int16))
    del cell_slot, dist, occ

    # three consecutive-z codes a word; z padded with empty slot 0
    words = torch.zeros((x_dim, y_dim, zw), dtype=torch.int32, device=device)
    for k in range(3):
        part = code[:, :, k::3].to(torch.int32)
        part <<= 10 * k
        words[:, :, : part.shape[2]] |= part
    packed_idx = _pillar_rows(words)
    del words, part

    # L3 cells: 4x4x4 fine cells; x and y padded as grid._block_occ pads
    # the half-resolution level (to multiples of 8), z up to whole cells
    qx = _ceil_multiple(x_dim // 2, 8) // 2
    qy = _ceil_multiple(y_dim // 2, 8) // 2
    qz = -(-z_dim // 4)
    code = F.pad(code, (0, 4 * qz - z_dim, 0, 4 * qy - y_dim,
                        0, 4 * qx - x_dim))
    blocks = code.view(qx, 4, qy, 4, qz, 4)
    top = blocks.amax(dim=(1, 3, 5))
    l3_occ = top >= RESERVED_SLOTS

    with span("vt.scene.distance"):
        bx, by = x_dim // 4, y_dim // 4  # the grid's own blocks, unpadded
        l3_d = F.pad(_capped_distance(l3_occ[:bx, :by], L3_DIST_CAP),
                     (0, 0, 0, qy - by, 0, qx - bx))

    with span("vt.scene.nodes"):
        cells = blocks >= RESERVED_SLOTS
        # the block's palette slot where all its occupied cells share it
        least = torch.where(cells, blocks, PALETTE_CAPACITY).amin(
            dim=(1, 3, 5))
        slot = torch.where(l3_occ.logical_and(least >= top), top, 0)
        slot = slot.to(torch.int64)
        # bit (x&3)*16 + (y&3)*4 + (z&3) of the block's 64-bit mask
        bits = cells.permute(0, 2, 4, 1, 3, 5).reshape(qx, qy, qz, 64)
        del blocks, code, cells, least, top
        lo, hi = _mask_half(bits[..., :32]), _mask_half(bits[..., 32:])
        del bits
        # (uint64 mask, slot) pairs in np.unique's order: the masks as
        # int64 with the top bit flipped keep their order, and their
        # ranks with the 10-bit slot fit one int64
        key = ((hi - (1 << 31)) << 32) | lo
        masks, rank = torch.unique(key.view(-1), return_inverse=True)
        pairs, inverse = torch.unique((rank << 10) | slot.view(-1),
                                      return_inverse=True)
        if pairs.numel() <= grid.BRICK_DEDUP_MAX:
            pairs = pairs.cpu().numpy()
            mask = (masks.cpu().numpy()[pairs >> 10].view(np.uint64)
                    ^ np.uint64(1 << 63))
            rows = max(8, -(-len(pairs) // 128))
            tab = np.zeros((3, rows * 128), np.uint32)
            tab[0, : len(pairs)] = mask & np.uint64(0xFFFFFFFF)
            tab[1, : len(pairs)] = mask >> np.uint64(32)
            tab[2, : len(pairs)] = pairs & 1023
            brick_idx = torch.from_numpy(
                tab.view(np.int32).reshape(3, rows, 128)).to(device)
            occupied = 0x8000 | inverse.view(qx, qy, qz)
        else:
            brick_idx = torch.stack([_pillar_rows(_int32(lo)),
                                     _pillar_rows(_int32(hi))])
            occupied = 0x8000 | slot
        meta16 = torch.where(l3_occ, occupied, l3_d.to(torch.int64))
        if qz % 2:
            meta16 = F.pad(meta16, (0, 1))
        m2 = meta16.view(qx, qy, -1, 2)
        meta_idx = _pillar_rows(_int32(m2[..., 0] | (m2[..., 1] << 16)))

    return {
        "packed_idx": packed_idx,
        "palette": torch.from_numpy(palette.reshape(8, 128)).to(device),
        "zw": zw,
        "meta_idx": meta_idx,
        "brick_idx": brick_idx,
        "l3_dims": (qx, qy, qz),
    }
