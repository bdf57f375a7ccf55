"""MagicaVoxel ``.vox`` (version 150) reader.

Capability-equivalent to the reference parser (``src/vox.rs:6-101``):
understands MAIN / PACK / SIZE / XYZI / RGBA / MATL chunks, supplies the
MagicaVoxel default palette when no RGBA chunk is present, and extracts
``_type`` / ``_flux`` from MATL dictionaries.  Unknown chunk ids (nTRN,
nGRP, rOBJ, ...) are skipped, like the reference does.

Differences from the reference, on purpose:
  * parsing is table-driven over a numpy byte buffer (XYZI decodes as one
    vectorized ``frombuffer`` instead of a per-voxel loop),
  * unknown MATL ``_type`` values degrade to ``diffuse`` with a warning
    instead of failing the whole file (``src/vox.rs:85-91`` errors out);
    every shipped asset only uses ``_diffuse`` so behaviour is identical
    on the reference's own scenes.

The benchmark's copy of the port's ``io/vox.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from .palette import DEFAULT_PALETTE

log = logging.getLogger("benchmark.reference.vox")

_MAGIC = b"VOX "
_SUPPORTED_VERSION = 150


class VoxError(ValueError):
    """Raised when a .vox file cannot be parsed."""


class MaterialKind(enum.Enum):
    DIFFUSE = "diffuse"
    EMIT = "emit"


@dataclasses.dataclass(frozen=True)
class Material:
    kind: MaterialKind = MaterialKind.DIFFUSE
    flux: float = 0.0


@dataclasses.dataclass(frozen=True)
class Model:
    """One voxel model: integer size and an (N, 4) uint8 array of
    ``x, y, z, color_index`` rows (MagicaVoxel is z-up)."""

    size: Tuple[int, int, int]
    voxels: np.ndarray  # (N, 4) uint8


@dataclasses.dataclass(frozen=True)
class Vox:
    models: List[Model]
    palette: np.ndarray  # (256,) uint32, 0xAABBGGRR
    materials: Dict[int, Material]

    def color_rgb(self, index: np.ndarray | int) -> np.ndarray:
        """Palette lookup -> (..., 3) uint8 RGB (low byte is red)."""
        c = self.palette[np.asarray(index)]
        return np.stack(
            [(c & 0xFF), (c >> 8) & 0xFF, (c >> 16) & 0xFF], axis=-1
        ).astype(np.uint8)


class _Cursor:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise VoxError("unexpected end of file")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def string(self) -> bytes:
        return self.take(self.u32())

    def dictionary(self) -> Dict[bytes, bytes]:
        return {self.string(): self.string() for _ in range(self.u32())}


@dataclasses.dataclass
class _Chunk:
    ident: bytes
    content: _Cursor
    children: _Cursor


def _read_chunk(cur: _Cursor) -> _Chunk:
    ident = cur.take(4)
    n_content = cur.u32()
    n_children = cur.u32()
    content = _Cursor(cur.buf, cur.pos, cur.pos + n_content)
    if content.end > cur.end:
        raise VoxError(f"chunk {ident!r} overruns file")
    children = _Cursor(cur.buf, content.end, content.end + n_children)
    if children.end > cur.end:
        raise VoxError(f"chunk {ident!r} children overrun file")
    cur.pos = children.end
    return _Chunk(ident, content, children)


def _parse_material(cur: _Cursor) -> Material:
    entries = cur.dictionary()
    kind = MaterialKind.DIFFUSE
    flux = 0.0
    if b"_type" in entries:
        t = entries[b"_type"]
        if t == b"_emit":
            kind = MaterialKind.EMIT
        elif t == b"_diffuse":
            kind = MaterialKind.DIFFUSE
        else:
            log.warning("material type %r not supported; treating as diffuse", t)
    if b"_flux" in entries:
        try:
            flux = float(entries[b"_flux"])
        except ValueError as e:
            raise VoxError(f"bad _flux value {entries[b'_flux']!r}") from e
    return Material(kind=kind, flux=flux)


def parse(data: bytes) -> Vox:
    if not data.startswith(_MAGIC):
        raise VoxError("not a VOX file (bad magic)")
    cur = _Cursor(data, len(_MAGIC))
    version = cur.i32()
    if version != _SUPPORTED_VERSION:
        raise VoxError(f"unsupported VOX version {version}")

    main = _read_chunk(cur)
    if main.ident != b"MAIN":
        raise VoxError("missing MAIN chunk")
    body = main.children

    model_count = 1
    saw_pack = False
    sizes: List[Tuple[int, int, int]] = []
    voxel_arrays: List[np.ndarray] = []
    palette = DEFAULT_PALETTE.copy()
    materials: Dict[int, Material] = {}

    while body.remaining() >= 12:
        chunk = _read_chunk(body)
        c = chunk.content
        if chunk.ident == b"PACK":
            # The reference only accepts PACK as the first MAIN child,
            # before any SIZE/XYZI pair (src/vox.rs:30-38).
            if saw_pack or sizes:
                raise VoxError("PACK chunk after model data")
            model_count = c.u32()
            saw_pack = True
        elif chunk.ident == b"SIZE":
            sizes.append((c.u32(), c.u32(), c.u32()))
        elif chunk.ident == b"XYZI":
            n = c.u32()
            raw = np.frombuffer(c.take(4 * n), dtype=np.uint8)
            voxel_arrays.append(raw.reshape(n, 4).copy())
        elif chunk.ident == b"RGBA":
            raw = np.frombuffer(c.take(4 * 255), dtype="<u4")
            # RGBA chunk holds colors for palette slots 1..255.
            palette = palette.copy()
            palette[1:256] = raw
        elif chunk.ident == b"MATL":
            mat_id = c.u32()
            materials[mat_id] = _parse_material(c)
        else:
            log.debug("skipping chunk %r", chunk.ident)

    if len(sizes) != len(voxel_arrays):
        raise VoxError("SIZE/XYZI chunk count mismatch")
    if len(sizes) != model_count:
        # The reference reads exactly model_count SIZE/XYZI pairs and
        # errors otherwise (src/vox.rs:40-55) — extras are malformed.
        raise VoxError(
            f"expected {model_count} models, found {len(sizes)}"
        )
    models = [
        Model(size=s, voxels=v)
        for s, v in zip(sizes[:model_count], voxel_arrays[:model_count])
    ]
    return Vox(models=models, palette=palette, materials=materials)


def load(path: str | os.PathLike) -> Vox:
    with open(path, "rb") as fh:
        return parse(fh.read())
