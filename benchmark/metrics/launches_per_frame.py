"""Frame driver: kernel launches a frame over the run (warm-up, window
and traced stretch), from the program's counters
(``voxtracer_torch.engine.pipeline.counters``): every ``launches.*``
over ``launches.trace``, since a frame launches the trace kernel once.
A program without the counters gives None."""


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    frames = counts.get("launches.trace", 0)
    if not frames:
        return None
    return sum(n for k, n in counts.items()
               if k.startswith("launches.")) / frames
