"""The port's scene layer: voxel lists, the dense grid and the trace
kernel's table ABI (``GridScene.device_tables()``), and the procedural
default scene.  Copies of ``voxtracer.scene``'s numpy modules, with the
pointer octree of the legacy Whitted mode in :mod:`.octree`."""

from .grid import CELL_SIZE, GridScene  # noqa: F401
from .procedural import default_scene  # noqa: F401
from .voxels import VoxelList, pack_leaves, voxels_from_vox  # noqa: F401
