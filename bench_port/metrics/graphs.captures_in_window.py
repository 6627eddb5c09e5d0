"""Programs captured inside the window: ``graphs_held()`` after it less
before it."""


def read(run):
    return run["captures"]
