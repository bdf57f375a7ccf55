"""Logging setup: console logging with env-var filtering.

Counterpart of :mod:`voxtracer.utils.log`: WARN by default, the
package's own namespace at INFO, overridable through an env filter
(``VOXTRACER_LOG``; e.g. ``debug`` or ``voxtracer_torch.ops=debug``).
"""

from __future__ import annotations

import logging
import os

NAMESPACE = "voxtracer_torch"


def setup_logging(env_var: str = "VOXTRACER_LOG") -> None:
    logging.basicConfig(
        level=logging.WARNING,
        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )
    logging.getLogger(NAMESPACE).setLevel(logging.INFO)

    spec = os.environ.get(env_var, "")
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        if "=" in clause:
            name, _, level = clause.partition("=")
            logging.getLogger(name).setLevel(level.upper())
        else:
            logging.getLogger().setLevel(clause.upper())
            logging.getLogger(NAMESPACE).setLevel(clause.upper())
