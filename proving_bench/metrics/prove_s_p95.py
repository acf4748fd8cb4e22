"""The 95th percentile (linear between order statistics) of the seconds of
every prove of the window, each timed from the prove's start to the end of
its serialization. A prove that raised counts with the time it took."""

import numpy as np


def read(run):
    seconds = [p.seconds for p in run.proves]
    return float(np.percentile(seconds, 95)) if seconds else None
