"""The whole training iteration's share of the H100's f32 peak, percent:
(the env step's frozen FLOPs + the learner's FLOPs per trained sample) x
the traced run's trained env-steps/s over 67 TFLOP/s. The port enables no
TF32, so the f32 peak is the ceiling of its matmuls too."""

from benchmark import stats


def read(rec):
    if not (rec.device_trace and rec.device_trace.ops and rec.traced_rate):
        return None
    c = rec.config
    return stats.f32_mfu(c["flops_per_env_step"] + c["learner_flops_per_sample"], rec.traced_rate)
