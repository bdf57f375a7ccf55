"""The MagicaVoxel default palette, constructed procedurally.

Files without an RGBA chunk use MagicaVoxel's built-in 256-color palette
(the reference embeds it as a literal table, ``src/vox.rs:103-136``).  Its
structure is regular, so we synthesize it instead of embedding 256 magic
numbers:

  index 0        : transparent black (0x00000000)
  indices 1-215  : a 6x6x6 color cube over levels {255,204,153,102,51,0},
                   blue varying fastest, then green, then red, all
                   descending from white, with the final black entry
                   omitted
  indices 216-225: red ramp   {238,221,187,170,136,119,85,68,34,17}
  indices 226-235: green ramp (same levels)
  indices 236-245: blue ramp  (same levels)
  indices 246-255: gray ramp  (same levels)

Entries are 0xAABBGGRR u32s (red in the low byte), matching
``Vox::get_color_rgb`` (``src/vox.rs:184-191``).

The port's copy of ``voxtracer/io/palette.py``.
"""

from __future__ import annotations

import numpy as np

_CUBE_LEVELS = (0xFF, 0xCC, 0x99, 0x66, 0x33, 0x00)
_RAMP_LEVELS = (0xEE, 0xDD, 0xBB, 0xAA, 0x88, 0x77, 0x55, 0x44, 0x22, 0x11)


def _pack(r: int, g: int, b: int, a: int = 0xFF) -> int:
    return (a << 24) | (b << 16) | (g << 8) | r


def _build() -> np.ndarray:
    colors = [0]
    for r in _CUBE_LEVELS:
        for g in _CUBE_LEVELS:
            for b in _CUBE_LEVELS:
                colors.append(_pack(r, g, b))
    colors.pop()  # the cube's all-black tail entry is not in the palette
    for v in _RAMP_LEVELS:
        colors.append(_pack(v, 0, 0))
    for v in _RAMP_LEVELS:
        colors.append(_pack(0, v, 0))
    for v in _RAMP_LEVELS:
        colors.append(_pack(0, 0, v))
    for v in _RAMP_LEVELS:
        colors.append(_pack(v, v, v))
    assert len(colors) == 256
    out = np.array(colors, dtype=np.uint32)
    out.setflags(write=False)
    return out


DEFAULT_PALETTE: np.ndarray = _build()
