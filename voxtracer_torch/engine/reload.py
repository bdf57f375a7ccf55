"""Kernel hot-reload: the reference's shader watcher for the port.

Counterpart of :mod:`voxtracer.engine.reload`, which reimports the JAX
package's kernel modules when their sources change.  The port's
"shaders" are two kinds of file, polled by mtime with the same 0.5 s
debounce:

* the CUDA sources ``voxtracer_torch/csrc/*.cu``: on a change the
  watcher builds them (``ops/_build.build``; the library's path hashes
  the sources, so a new library is written) and clears ``_build.load``'s
  cache.  Every kernel wrapper calls ``_build.load()`` per launch, so
  the next frame runs the new library.  ctypes never closes a library
  it loaded, so the old one stays mapped: a CUDA graph captured from it
  may still point into it.  A failed build is logged, the old library
  stays loaded and :meth:`KernelWatcher.poll` returns False;
* the kernel wrappers ``voxtracer_torch/ops/*.py``: on a change the
  watcher reloads the modules (``importlib.reload``); a failed import is
  logged and the previous code keeps running.

After either, ``on_reload`` runs; :func:`renderer_hook` makes the one a
viewer needs.  A failure anywhere is logged and never fatal, like a
failed shader compile in the reference.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional

from ..ops import _build

log = logging.getLogger("voxtracer_torch.engine.reload")

WATCHED_MODULES = (
    "voxtracer_torch.ops.trace",
    "voxtracer_torch.ops.temporal",
    "voxtracer_torch.ops.denoise",
    "voxtracer_torch.ops.reproject",
    "voxtracer_torch.ops.tonemap",
    "voxtracer_torch.ops.epilogue",
)


def renderer_hook(renderer) -> Callable[[], None]:
    """The ``on_reload`` of a viewer's renderer: its frame plan and its
    sequence runner are dropped.  The next frame builds a plan that
    counts the reloaded wrappers and calls the library loaded now, and
    no CUDA graph replays a kernel of the library it replaced; the
    stages themselves are read from their modules at each frame."""

    def on_reload():
        renderer._plan = None
        renderer._runner = None

    return on_reload


def _reload(module):
    """``importlib.reload(module)``; its kernel wrappers' ``launches``
    go on from their predecessors', so that ``engine.pipeline.counters``
    never decreases."""
    launches = {k: v.launches for k, v in vars(module).items()
                if callable(v) and hasattr(v, "launches")}
    importlib.reload(module)
    for k, n in launches.items():
        new = getattr(module, k, None)
        if hasattr(new, "launches"):
            new.launches = n


class KernelWatcher:
    """Polls the kernel sources' mtimes; on a change rebuilds the CUDA
    library or reloads the wrapper modules, then calls ``on_reload``.
    The CUDA sources are those of ``_build.CSRC_DIR`` at each poll."""

    def __init__(
        self,
        on_reload: Optional[Callable[[], None]] = None,
        modules: Iterable[str] = WATCHED_MODULES,
        debounce: float = 0.5,
    ):
        self.on_reload = on_reload
        self.modules = list(modules)
        self.debounce = debounce
        self._last_event = float("-inf")  # the first change is never held
        self._mtimes: Dict[str, float] = {}
        self._mtimes = self._changed()

    def _files(self):
        for name in self.modules:
            mod = sys.modules.get(name)
            if mod is not None and getattr(mod, "__file__", None):
                yield name, mod.__file__
        for path in _build._sources():
            yield path, path

    def _changed(self) -> Dict[str, float]:
        """The files whose mtime differs from the recorded one, with
        their mtimes (every file before the first record)."""
        changed = {}
        for key, path in self._files():
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if mtime != self._mtimes.get(key):
                changed[key] = mtime
        return changed

    def poll(self) -> bool:
        """Check for changes; rebuild or reload if any.  Returns True
        when new kernels are in use.  A change within the debounce window
        of the last one waits for a later poll (the reference drops it)."""
        changed = self._changed()
        if not changed:
            return False
        now = time.monotonic()
        if now - self._last_event < self.debounce:
            return False
        self._last_event = now
        self._mtimes.update(changed)

        if any(key not in self.modules for key in changed):
            try:
                t0 = time.perf_counter()
                path = _build.build()
            except Exception:
                # non-fatal, like the reference's shader-compile errors
                log.exception("kernel build failed; keeping the loaded "
                              "library")
                return False
            _build.load.cache_clear()
            log.info("rebuilt the kernels in %.2f s: %s",
                     time.perf_counter() - t0, os.path.basename(path))
        for name in changed:
            if name not in self.modules:
                continue
            try:
                _reload(sys.modules[name])
                log.info("reloaded kernel module %s", name)
            except Exception:
                log.exception("reload of %s failed; keeping previous "
                              "kernels", name)
                return False
        if self.on_reload is not None:
            try:
                self.on_reload()
            except Exception:
                log.exception("pipeline rebuild failed after reload")
                return False
        return True
