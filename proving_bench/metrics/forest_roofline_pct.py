"""Kernels K1 and K2's share of their roofline over the traced window: the
least time of the 43-tree forest of every prove (work/forest.py, from the
proof's variable count) over the kernels' device time."""

from benchlib import roofline


def read(run):
    works = [run.work("forest").count(p.num_vars) for p in run.good()]
    return roofline.share_pct(run, "forest", works)
