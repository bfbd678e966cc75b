"""K1's share of its roofline, percent: the least time the H100 could take
for one launch at the cell's env count (the larger of the frozen semantic
FLOPs over 67 TFLOP/s and the frozen bytes over 3.35 TB/s) over K1's mean
device time per launch in the profiled stretch."""

from benchmark import stats


def read(rec):
    if not rec.device_trace:
        return None
    k1 = rec.device_trace.kernels(rec.config["k1_kernel"])
    if not k1:
        return None
    mean_s = sum(e - s for _, _, s, e in k1) * 1e-9 / len(k1)
    n, c = rec.num_envs, rec.config
    return stats.roofline_share(n * c["flops_per_env_step"], n * c["bytes_per_env_step"], mean_s)
