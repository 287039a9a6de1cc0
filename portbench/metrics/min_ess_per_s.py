"""The sum over the window's jobs of each job's min-over-dims ESS
(``portbench/ess.py``), over the window's timed seconds."""


def read(run):
    return sum(j.min_ess for j in run.jobs) / run.window_s
