"""The trace's reduction on a made-up profile: the device's busy time is
the union of its work; a host range mirrored onto the device's row and a
collective's kernel (it spins while it waits) are no work; the
collectives of the warmup and the fused kernels of the sampling fall on
their sides of the split; idle gaps go to the host call running."""

import types

from torch.autograd import DeviceType

from portbench import trace


def _event(name, start, end, device):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_reduce():
    cpu = [("portbench.job", 0, 1000), ("nccl:all_reduce", 100, 300),
           ("aten::mean", 300, 400), ("cudaDeviceSynchronize", 800, 900)]
    dev = [("portbench.job", 0, 1000), ("nccl:all_reduce", 100, 300),
           ("ncclDevKernel_AllReduce_Sum_f32", 150, 250),
           ("generic_kernel<LogisticForm>", 700, 800),
           ("generic_kernel<LogisticForm>", 780, 850),
           ("Memcpy DtoD (Device -> Device)", 860, 870)]
    prof = types.SimpleNamespace(events=lambda: [
        *(_event(*c, False) for c in cpu), *(_event(*d, True) for d in dev)])
    job = types.SimpleNamespace(sampling_s=300e-6, wall_s=1e-3,
                                counts=[[4], [4]])
    run = types.SimpleNamespace(
        cfg={"fused_kernels": ["generic_kernel"], "num_dims": 32},
        local=8, traffic={"warmup": 2, "samples": 2},
        count=types.SimpleNamespace(
            transition_bound_s=lambda w, d, n, cfg: 1e-5))
    t = trace.reduce(prof, job, run)
    # the kernels and the copy; the collective's kernel is no work
    assert abs(t["busy_s"] - 160e-6) < 1e-12  # 150 + 10 us
    assert t["launches"] == 3
    assert abs(t["nccl_warmup_s"] - 100e-6) < 1e-12
    assert t["fused_sampling_launches"] == 2
    assert abs(t["fused_sampling_device_s"] - 170e-6) < 1e-12
    assert abs(t["fused_sampling_bound_s"] - 2e-5) < 1e-15
    gaps = dict(t["breakdown"]["idle_gaps"])
    # 0 .. 700, the collective's wait with it
    assert abs(gaps["aten::mean"] - 700e-6) < 1e-12
    assert abs(gaps["cudaDeviceSynchronize"] - 10e-6) < 1e-12
    ops = dict(t["breakdown"]["device_ops"])
    assert "nccl:all_reduce" not in ops and "portbench.job" not in ops
