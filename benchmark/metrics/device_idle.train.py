"""Percent of the profiled stretch (two training iterations) in which no
operation ran on the card: the union of the device operations' intervals
from the in-memory profile, against the stretch's length."""


def read(rec):
    return rec.device_trace.idle_pct() if rec.device_trace else None
