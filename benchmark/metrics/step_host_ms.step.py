"""The host's time in one `step_fn` call, ms: the mean of the harness's
spans around every call of the traced run's window (the call returns once
its work is queued, or once the card's queue has room for it)."""


def read(rec):
    if not (rec.spans and rec.device_trace and rec.device_trace.ops):
        return None
    return rec.spans.mean_ms("step_fn")
