"""Share of the traced stretch's wall time in which no operation ran on the
device: 1 minus the union of the device events' intervals over it."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
