"""Device busy time (the union of the device events' intervals) over the
traced stretch, per frame in it."""


def read(run):
    tr = run["trace"]
    if not tr or not run["trace_frames"]:
        return None
    return tr["busy_s"] * 1e3 / run["trace_frames"]
