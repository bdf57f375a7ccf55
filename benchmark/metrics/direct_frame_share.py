"""Frame driver: the share of frames that one native call enqueued, over
the run (warm-up, window and traced stretch), from the program's
counters (``voxtracer_torch.engine.pipeline.counters``):
``frames.direct`` over ``launches.trace``, since a frame launches the
trace kernel once.  A program without the counter gives None."""


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    frames = counts.get("launches.trace", 0)
    if "frames.direct" not in counts or not frames:
        return None
    return counts["frames.direct"] / frames
