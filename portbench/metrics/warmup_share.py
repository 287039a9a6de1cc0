"""Percent of a job's wall in warmup: (wall - the result's
``sampling_seconds``) / wall, summed over the window's unprofiled jobs."""


def read(run):
    jobs = [j for j in run.jobs if not j.profiled and not j.failed]
    wall = sum(j.wall_s for j in jobs)
    if not wall:
        return None
    return 100.0 * sum(j.wall_s - j.sampling_s for j in jobs) / wall
