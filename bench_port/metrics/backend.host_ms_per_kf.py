"""Host ms of the keyframe back end per keyframe: the sum of
``info["backend_ms"]`` over the window's keyframes, over their count."""


def read(run):
    ms = run["backend_ms"]
    return sum(ms) / len(ms) if ms else None
