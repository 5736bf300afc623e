"""device_idle_pct.join: the share of the profiled window in which no
operation ran on the card (device trace)."""


def read(run):
    return run.trace.idle_pct() if run.trace is not None else None
