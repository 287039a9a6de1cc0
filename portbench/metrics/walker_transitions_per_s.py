"""Walkers x (warmup + sampling transitions) of every job of the window,
over the window's timed seconds (host clock, each job device-synced)."""


def read(run):
    work = sum(run.walkers * (run.traffic["warmup"] + run.traffic["samples"])
               for _ in run.jobs)
    return work / run.window_s
