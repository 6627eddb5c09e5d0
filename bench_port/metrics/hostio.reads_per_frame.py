"""Blocking device->host reads (``SlamSystem.host_reads``, all kinds) over
the window, per frame that came back."""


def read(run):
    return run["host_reads"] / run["frames"] if run["frames"] else None
