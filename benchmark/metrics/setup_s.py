"""Process start to the first timed frame: imports, the CUDA context,
the kernels (built on a checkout's first run, loaded after), the scene
tables, the blue-noise asset, the warm-up and the graph captures."""


def read(run):
    return run.setup_s
