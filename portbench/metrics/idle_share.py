"""The share of the window's wall time in which the card ran nothing, in
%: 1 - (device busy seconds a unit) / (wall seconds a unit).

The busy time is the union of the device operations' intervals in the
traced stretch (overlapping kernels and copies count once), over its
units; the wall time a unit is that of the same run's window before the
stretch, which runs without the profiler, so that the profiler's own host
stalls, which an untraced run does not have, are no idle time.  A reading
below 0 would say the profiler slowed the card itself."""


def read(rec):
    if rec.trace is None or not rec.trace.units or not rec.untraced:
        return None
    units, seconds = rec.untraced
    if units <= 0 or seconds <= 0:
        return None
    return 100.0 * (1.0 - (rec.trace.busy_s / rec.trace.units) / (seconds / units))
