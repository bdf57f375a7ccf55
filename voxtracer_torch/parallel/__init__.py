"""Row-slab rendering over several devices (the JAX package's
``voxtracer.parallel``)."""

from .mesh import (  # noqa: F401
    gather_state,
    make_mesh,
    scene_device_args,
    sharded_render_frame,
)
