"""Device: the share of the traced window in which no kernel, memset or
copy ran on the card, in percent."""


def read(run):
    if run.trace is None or run.trace.window_us() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us())
