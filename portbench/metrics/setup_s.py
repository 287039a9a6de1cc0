"""Seconds from the process's start to the first timed job: imports, the
CUDA context, the kernels (built on a checkout's first run, loaded from
the program's ``_build/`` after), the data and one short job at the
cell's shapes."""


def read(run):
    return run.setup_s
