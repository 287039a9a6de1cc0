"""Percent of the card's peak that a whole sampling transition reaches: the
frozen bound of every sampling transition of the window's unprofiled jobs
(``portbench/counts``, whatever kernels implement it) over their
``sampling_seconds``."""


def read(run):
    jobs = [j for j in run.jobs if not j.profiled and not j.failed]
    seconds = sum(j.sampling_s for j in jobs)
    if not seconds:
        return None
    return 100.0 * sum(j.sampling_bound_s for j in jobs) / seconds
