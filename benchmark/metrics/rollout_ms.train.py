"""The rollout's time per iteration (16 policy forwards and K1 steps), ms:
the device time between the learner's own CUDA events, read after every
call of the traced run's window (each call's last iteration), the mean."""


def read(rec):
    xs = rec.learner_ms.get("rollout")
    return sum(xs) / len(xs) if xs and rec.device_trace and rec.device_trace.ops else None
