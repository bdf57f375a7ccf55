"""The frame's random numbers: one fixed (S, 128, 128) float32 buffer.

``rand()`` slot k of bounce b at pixel (y, x) on frame f reads
``buffer[(f + 1 + 8*b + k) % S, y % 128, x % 128]`` (the reference
package's fixed slot schedule, ``voxtracer/ops/noise.py``).  The buffers
themselves come from the reference package's jax-free modules: the
baked blue-noise asset, or seeded white noise for tests.
"""

from voxtracer.ops.bluenoise import cached_buffer as blue_noise_buffer  # noqa: F401
from voxtracer.ops.noise import white_noise_buffer  # noqa: F401
