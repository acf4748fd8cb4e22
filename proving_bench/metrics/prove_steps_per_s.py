"""Executed RISC-V steps of every prove in the window over the window's
whole time, from the first prove's start to the last serialization's end."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(p.steps for p in run.proves) / run.window_s
