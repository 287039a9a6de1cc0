"""Percent: the frozen bound (``portbench/counts``) of the profiled job's
sampling launches of the program's fused transition kernel, at the
leapfrog counts they ran, over their device time in the trace."""


def read(run):
    t = run.trace
    if t is None or not t["fused_sampling_launches"]:
        return None
    return 100.0 * t["fused_sampling_bound_s"] / t["fused_sampling_device_s"]
