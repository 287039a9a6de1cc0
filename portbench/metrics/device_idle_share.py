"""Percent of a job's time the card is idle: 1 - the profiled job's device
busy time (the union of its kernels, copies and fills, averaged over the
cards; a collective's kernel, which spins while it waits for the slowest
rank, counts as idle) over the mean wall of the same run's unprofiled
jobs (the profiler's host overhead stretches the profiled job's own
wall)."""


def read(run):
    jobs = [j for j in run.jobs if not j.profiled and not j.failed]
    if run.trace is None or not jobs:
        return None
    wall = sum(j.wall_s for j in jobs) / len(jobs)
    return 100.0 * (1.0 - run.trace["busy_s"] / wall)
