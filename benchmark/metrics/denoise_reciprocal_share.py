"""Denoise stage: the share of the denoise kernel's launches whose range
quotient took one correction from the launch's reciprocal (Markstein's
test passed; ``voxtracer_torch/ops/denoise.py`` ``range_reciprocal``),
over the run (warm-up, window and traced stretch), from the program's
counters (``voxtracer_torch.engine.pipeline.counters``):
``denoise.reciprocal_launches`` over ``launches.denoise``.  A program
without the counter, or with no denoise launch, gives None."""


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    launches = counts.get("launches.denoise", 0)
    if "denoise.reciprocal_launches" not in counts or not launches:
        return None
    return counts["denoise.reciprocal_launches"] / launches
