"""Frame driver (``Renderer.render``): mean host microseconds of a
``render()`` call over the window (the harness's span around it)."""


def read(run):
    rec = run.record
    if "rets" not in rec or not rec["rets"]:
        return None
    d = [b - a for a, b in zip(rec["calls"], rec["rets"])]
    return sum(d) / len(d) * 1e6
