"""The reduction of one profiled job's ``torch.profiler`` trace to what the
per-layer metrics read: the device's busy time, launches, the fused
kernels' sampling launches against their frozen bound, the collectives of
the warmup, and the ``breakdown`` (the top device operations; the idle
gaps by the host call that was running).

The profiled job's timeline is split into warmup and sampling at the
host time where sampling began: the end of the sampler's last device
synchronisation (the end of its sampling loop) less the result's
``sampling_seconds``.
"""

from __future__ import annotations

import bisect

SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
WRAPPER = "portbench.job"
TOP = 10


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:TOP]]


def reduce(prof, job, run) -> dict:
    """The job's trace, reduced (times in seconds)."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in prof.events():
        item = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else cpu).append(item)
    # a host range the profiler mirrors onto the device's row (this job's
    # wrapper, a collective's "nccl:all_reduce") is a span, not work: no
    # kernel, copy or fill bears a host call's name
    names = {c[2] for c in cpu}
    dev = [d for d in dev if d[2] not in names]
    wrap = [c for c in cpu if c[2] == WRAPPER]
    t0, t1 = (wrap[0][0], wrap[0][1]) if wrap else (
        min(c[0] for c in cpu), max(c[1] for c in cpu))
    dev = [d for d in dev if d[1] >= t0]
    kernels = [d for d in dev if not d[2].startswith(NOT_KERNELS)]
    syncs = [c[1] for c in cpu if c[2] in SYNCS and t0 <= c[1] <= t1]
    split = (max(syncs) if syncs else t1) - 1e6 * job.sampling_s
    fused = [d for d in kernels if d[0] >= split
             and any(p in d[2] for p in run.cfg["fused_kernels"])]
    nccl = [d for d in kernels if d[0] < split and "nccl" in d[2].lower()]
    # a collective's kernel spins on the card while it waits for the
    # slowest rank: that wait is no work, so it counts as idle here and on
    # its own in ``nccl_warmup_s``
    busy = _union([(a, b) for a, b, name in dev
                   if "nccl" not in name.lower()])
    busy_us = sum(b - a for a, b in busy)
    # the sampling launches' bound: their counts as run, in order
    bounds = [run.count.transition_bound_s(run.local, run.cfg["num_dims"],
                                           c[0], run.cfg)
              for c in job.counts]
    per_launch = sum(bounds) / len(bounds) if bounds else 0.0
    ops = {}
    for a, b, name in dev:
        ops[name[:160]] = ops.get(name[:160], 0.0) + (b - a) / 1e6
    # idle gaps, each put to the innermost host call running at its middle
    end = max([t1] + [b for _, b in busy])
    edges = [t0] + [x for iv in busy for x in iv] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host = sorted((c for c in cpu if c[2] != WRAPPER), key=lambda c: c[0])
    starts = [c[0] for c in host]
    idle = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name, best = "(between torch calls)", None
        for k in range(i, max(i - 400, -1), -1):
            s, e, n = host[k]
            if e >= mid and (best is None or e - s < best):
                name, best = n, e - s
        idle[name[:160]] = idle.get(name[:160], 0.0) + (b - a) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": job.wall_s,
        "launches": len(kernels),
        "transitions": run.traffic["warmup"] + run.traffic["samples"],
        "fused_sampling_launches": len(fused),
        "fused_sampling_device_s": sum(b - a for a, b, _ in fused) / 1e6,
        "fused_sampling_bound_s": per_launch * len(fused),
        "nccl_warmup_s": sum(b - a for a, b, _ in nccl) / 1e6,
        "breakdown": {"device_ops": _top(ops), "idle_gaps": _top(idle)},
    }
