"""A job's min ESS over the gradients its sampling spent (walkers x
sampling transitions x leapfrog steps a transition: L, or the result's
``mean_num_steps``), averaged over the window's jobs: what the adaptation
buys per unit of work."""


def read(run):
    jobs = [j for j in run.jobs if not j.failed]
    if not jobs:
        return None
    s = run.traffic["samples"]
    return sum(j.min_ess / (run.walkers * s * j.steps_per_sampling_transition)
               for j in jobs) / len(jobs)
