"""The two-box step cells' own metric (for a bound of their own): device
operations (kernels, copies and fills) per env step other than K1, in the
profiled stretch: what the step wrapper launches around it."""


def read(rec):
    if not (rec.device_trace and rec.device_trace.ops and rec.stretch_steps):
        return None
    k1 = rec.config["k1_kernel"]
    return sum(1 for op in rec.device_trace.ops if k1 not in op[0]) / rec.stretch_steps
