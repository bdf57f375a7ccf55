"""The window's milliseconds over the frames whose u8 image reached host
memory inside it: the reciprocal of the frame rate a viewer or an
exporter gets.  A stall anywhere in the window shows."""


def read(run):
    units = run.delivered()
    frames = len(units) * run.record["frames_per_unit"]
    return run.seconds * 1e3 / frames if frames else None
