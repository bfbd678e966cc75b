"""The two-box step cells' own metric (for a bound of their own): percent of
the profiled stretch (chained two-box env steps) in which no operation ran
on the card: the union of the device operations' intervals from the
in-memory profile, against the stretch's length."""


def read(rec):
    return rec.device_trace.idle_pct() if rec.device_trace else None
