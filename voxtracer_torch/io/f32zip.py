"""The raw-f32 zip resource format of the noise assets.

Counterpart of :mod:`voxtracer.io.f32zip` (byte-identical files): one
file per noise slice, big-endian u32 width, u32 height, then ``w*h``
big-endian f32 pixels.
"""

from __future__ import annotations

import io
import os
import struct
import zipfile

import numpy as np


def read_f32zip(path: str | os.PathLike) -> np.ndarray:
    """-> (count, h, w) float32.  All images must be square and of one
    size."""
    slices = []
    size = None
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if name.endswith("/"):
                continue
            data = zf.read(name)
            w, h = struct.unpack(">II", data[:8])
            if w != h:
                raise ValueError(f"non-square noise image {name}: {w}x{h}")
            if size is None:
                size = w
            elif size != w:
                raise ValueError("noise images differ in size")
            pix = np.frombuffer(data[8 : 8 + 4 * w * h], dtype=">f4")
            slices.append(pix.reshape(h, w).astype(np.float32))
    if not slices:
        raise ValueError("archive contained no images")
    return np.stack(slices)


def write_f32zip(path: str | os.PathLike, noise: np.ndarray) -> None:
    """(count, h, w) float32 -> a zip in the format above."""
    noise = np.asarray(noise, np.float32)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for i, img in enumerate(noise):
            h, w = img.shape
            buf = io.BytesIO()
            buf.write(struct.pack(">II", w, h))
            buf.write(img.astype(">f4").tobytes())
            zf.writestr(f"{i:04d}.f32", buf.getvalue())
