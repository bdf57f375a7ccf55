"""Sequence driver: device activities (kernels, memsets, copies) a
replayed frame in the traced window, from the first frame's trace
kernel to the last frame's, over the frames between; a batch's or a
call's copies in and out are spread over its frames."""


def read(run):
    return None if run.trace is None else run.trace.ops_per_frame()
