"""The LK kernel's share of its roofline over the traced stretch
(``roofline/lk_fb.py``)."""

from bench_port import roofline


def read(run):
    return roofline.share(run["trace"], "lk_fb", run["config"])
