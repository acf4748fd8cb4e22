"""Kernels N1, N2 and K5's share of their roofline over the traced window:
the least time of one encode and one column hash of each Ligero commit of
every prove (work/ligero.py, from the commit shapes the prover records)
over the kernels' device time. The openings' re-encodes are in that time
and not in the least work."""

from benchlib import roofline


def read(run):
    ligero = run.work("ligero")
    works = [ligero.count(p.timings) for p in run.good()]
    return roofline.share_pct(run, "ligero", [w for w in works if w is not None])
