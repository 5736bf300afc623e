"""join_translate_host_ms: the program's ``csvplus:join:translate``
profiler ranges, summed over the profiled window and per query there.
Nothing waits for the card there, so this is the host's own time in the
stage, without the collector's barriers (device trace's host side)."""

RANGE = "csvplus:join:translate"


def read(run):
    if run.trace is None or not run.profiled_units:
        return None
    ns = sum(e - s for s, e, n in run.trace.ranges if n == RANGE)
    return ns / 1e6 / run.profiled_units if ns else None
