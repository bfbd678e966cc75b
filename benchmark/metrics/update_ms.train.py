"""The learner's update time per iteration (GAE, moments, shuffles and the
minibatch updates), ms: the device time between the learner's own CUDA
events (`rl/ppo.py` `iteration_seconds`), read after every call of the
traced run's window (each call's last iteration), the mean."""


def read(rec):
    xs = rec.learner_ms.get("update")
    return sum(xs) / len(xs) if xs and rec.device_trace and rec.device_trace.ops else None
