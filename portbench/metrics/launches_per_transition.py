"""Kernel launches on the device in the profiled job (every kernel the
trace holds, copies and fills left out), over its transitions: the
samplers' launch overhead."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["launches"] / run.trace["transitions"]
