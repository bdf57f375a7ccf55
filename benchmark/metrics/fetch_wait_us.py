"""Lookahead fetch (``LookaheadFetch.push``): mean host microseconds of
a ``push()`` over the window (the harness's span around it), most of it
the wait for the previous frame's copy to the host."""


def read(run):
    rec = run.record
    if "pushes" not in rec or not rec["pushes"]:
        return None
    d = [b - a for a, b in zip(rec["rets"], rec["pushes"])]
    return sum(d) / len(d) * 1e6
