"""Frame epilogue: the bytes that the still epilogue (on the picked
frame's data: which pixels hit, which keep their history) and the encode
must move, over 3.35 TB/s, over the two kernels' device time on the
picked traced frames, in percent."""

from benchmark import counts

STILL, ENCODE = "still_epilogue_kernel", "encode_kernel"


def read(run):
    if run.trace is None or not run.picks:
        return None
    frames = run.trace.frames()
    albedo = run.radius == 0
    nbytes, t = 0, 0.0
    for p in run.picks:
        if p.position >= len(frames):
            return None
        for name, s, e in frames[p.position]:
            if STILL in name:
                nbytes += counts.still_bytes(p.depth, p.kept, p.history_valid,
                                             albedo=albedo)
            elif ENCODE in name:
                nbytes += counts.encode_bytes(run.height, run.width, albedo)
            else:
                continue
            t += (e - s) * 1e-6
    if t <= 0:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / t
