"""The ORB kernel's share of its roofline over the traced stretch
(``roofline/orb.py``)."""

from bench_port import roofline


def read(run):
    return roofline.share(run["trace"], "orb", run["config"])
