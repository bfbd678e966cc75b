"""The whole env step's share of the H100's f32 peak, percent: the env
step's frozen semantic FLOPs x the traced run's env-steps/s over 67
TFLOP/s."""

from benchmark import stats


def read(rec):
    if not (rec.device_trace and rec.device_trace.ops and rec.traced_rate):
        return None
    return stats.f32_mfu(rec.config["flops_per_env_step"], rec.traced_rate)
