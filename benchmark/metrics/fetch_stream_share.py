"""Lookahead fetch: the share of the fetch's host copies that ran on its
own copy stream, over the run (warm-up, window and traced stretch), from
the program's counters (``voxtracer_torch.engine.pipeline.counters``):
``fetch.stream_copies`` over ``fetch.copies``.  A program without the
counters, or with no copy, gives None."""


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    copies = counts.get("fetch.copies", 0)
    if "fetch.stream_copies" not in counts or not copies:
        return None
    return counts["fetch.stream_copies"] / copies
