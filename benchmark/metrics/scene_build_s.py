"""Scene build: the host seconds of the program's scene build over the
run, from its counters (``voxtracer_torch.engine.pipeline.counters``):
``scene.load_us`` (voxels and grid), ``scene.tables_us``
(``device_tables()``) and ``scene.upload_us`` (the tables' copies to
the device).  A program without the counters gives None."""

KEYS = ("scene.load_us", "scene.tables_us", "scene.upload_us")


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    if not all(k in counts for k in KEYS):
        return None
    return sum(counts[k] for k in KEYS) / 1e6
