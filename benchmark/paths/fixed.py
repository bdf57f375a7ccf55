"""One fixed pose, given in the workload: the port's ``app/bench.py``
config 2 pose for menger (position (36, 34, -5), direction
(-16, -14, 25)), or config 5's ``camera_paths.static`` pose for castle."""

import numpy as np


def make(world_min, world_max, position, direction):
    """``f(t) -> (position, direction)``, the same at every ``t``."""
    pos = np.asarray(position, np.float64)
    direction = np.asarray(direction, np.float64)

    def path(t: float):
        return pos, direction

    return path
